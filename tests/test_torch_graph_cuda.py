"""The captured stream step on the card: CUDA graph replays against the
eager step, at a narrow width with every kernel on the path.

A 256x256 stream (latent 32x32, so the top level's 1024 positions pass the
flash gate) through a narrow UNet, with ``flash_variant="int8"`` and the
GroupNorm and LayerNorm kernels at every site: the replays run the stream
attention (either cache dtype), d-major and int8-QK flash (its cluster
pre-pass too), the conv at both strides, LayerNorm and GroupNorm (its
cooperative launch). These need an NVIDIA Hopper GPU and ``nvcc``; without
a CUDA device each test skips. Run them on the card, from the repository
root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_graph_cuda.py

The same kernels in the same order draw the same noise from the same
generator state, so replays equal the eager step bit for bit.
"""

from __future__ import annotations

import gc

import pytest
import torch

from live2diff_tpu_torch.ops import _build
from live2diff_tpu_torch.stream.graph import state_tensors

pytestmark = pytest.mark.cuda

SIZE = 256
NARROW_UNET = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=2,
                   cross_attention_dim=64, norm_num_groups=8, motion_num_attention_heads=2)
CONFIG = {
    "num_inference_steps": 50, "t_index_list": [30, 40],
    "unet_additional_kwargs": {"motion_module_kwargs": {
        "num_attention_heads": 2, "attention_kwargs": {"window_size": 16, "sink_size": 8},
    }},
}
# through window fill and eviction (window 16, sink 8)
FRAMES = 24


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _stream(dev, cache="int8"):
    from live2diff_tpu_torch.builder import build_pipeline

    return build_pipeline(CONFIG, SIZE, SIZE, dtype=torch.bfloat16, kv_cache_dtype=cache,
                          output_uint8=True, seed=0, device=dev, unet_overrides=NARROW_UNET,
                          use_depth=False, flash_variant="int8", gn_kernel_sites="all",
                          ln_kernel_sites="all").stream


def _inputs(dev, n, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompt = torch.randn(1, 77, 64, generator=gen, device=dev)
    warm = torch.rand(8, SIZE, SIZE, 3, generator=gen, device=dev) * 2 - 1
    frames = torch.randint(0, 256, (n, SIZE, SIZE, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    return prompt, warm, frames


def _eager(stream, state, frame):
    return stream._frame_step(state, frame, stream._prompt_embeds)


def _assert_twins(a, b):
    assert a.frame_idx == b.frame_idx
    for x, y in zip(state_tensors(a), state_tensors(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("cache", ["int8", "bf16"])
def test_captured_step_equals_the_eager_step(dev, cache):
    stream = _stream(dev, cache)
    prompt, warm, frames = _inputs(dev, FRAMES)
    state_g, _ = stream.prepare(warm, prompt, seed=2)
    state_e, _ = stream.prepare(warm, prompt, seed=2)
    _build.reset_launch_counts()
    for i, frame in enumerate(frames):
        state_g, out_g = stream(state_g, frame)
        state_e, out_e = _eager(stream, state_e, frame)
        assert torch.equal(out_g, out_e), f"frame {i}"
    _assert_twins(state_g, state_e)
    assert len(stream._graphs.graphs) == 1
    # launches through the wrappers: the FRAMES eager steps, the warm step
    # before the capture and the capture; none at replay
    for name in (f"stream_attention_{cache}", "flash_attention", "flash_attention_int8",
                 "conv3x3", "conv3x3_s2", "layer_norm", "group_norm"):
        n = _build.launch_counts[name]
        assert n and n % (FRAMES + 2) == 0, (name, n)


def test_set_prompt_after_capture(dev):
    """A prompt set after the capture reaches the next replay: the graph
    reads the prompt buffer, which set_prompt writes in place."""
    stream = _stream(dev)
    prompt, warm, frames = _inputs(dev, 2)
    new_prompt = torch.randn(1, 77, 64, generator=torch.Generator(device=dev).manual_seed(9),
                             device=dev)
    state_g, _ = stream.prepare(warm, prompt, seed=2)
    state_e, _ = stream.prepare(warm, prompt, seed=2)
    state_old, _ = stream.prepare(warm, prompt, seed=2)
    old = stream._prompt_embeds.clone()
    state_g, _ = stream(state_g, frames[0])
    state_e, _ = _eager(stream, state_e, frames[0])
    state_old, _ = _eager(stream, state_old, frames[0])
    stream.set_prompt(new_prompt)
    _, out_g = stream(state_g, frames[1])
    _, out_e = _eager(stream, state_e, frames[1])
    _, out_old = stream._frame_step(state_old, frames[1], old)
    assert torch.equal(out_g, out_e)
    assert not torch.equal(out_g, out_old)
    assert len(stream._graphs.graphs) == 1


def test_two_states_on_one_stream_each_with_its_own_graph(dev):
    stream = _stream(dev)
    prompt, warm, frames = _inputs(dev, 6)
    states = {seed: [stream.prepare(warm, prompt, seed=seed)[0] for _ in range(2)]
              for seed in (2, 3)}
    for i, frame in enumerate(frames):
        for seed, (state_g, state_e) in states.items():
            state_g, out_g = stream(state_g, frame)
            state_e, out_e = _eager(stream, state_e, frame)
            assert torch.equal(out_g, out_e), (seed, i)
            states[seed] = [state_g, state_e]
    assert len(stream._graphs.graphs) == 2
    for state_g, state_e in states.values():
        _assert_twins(state_g, state_e)


def test_outputs_held_across_calls_are_not_overwritten(dev):
    stream = _stream(dev)
    prompt, warm, frames = _inputs(dev, 4)
    state_g, _ = stream.prepare(warm, prompt, seed=2)
    state_e, _ = stream.prepare(warm, prompt, seed=2)
    held, expected = [], []
    for frame in frames:
        state_g, out = stream(state_g, frame)
        held.append(out)
        state_e, out = _eager(stream, state_e, frame)
        expected.append(out)
    torch.cuda.synchronize()
    assert len({t.data_ptr() for t in held}) == len(held)
    for a, b in zip(held, expected):
        assert torch.equal(a, b)


def test_a_dropped_states_graph_lets_its_caches_go(dev):
    """The graph holds its state's tensors weakly: dropping the state frees
    its caches at once, and the next prepare() releases the graph."""
    stream = _stream(dev)
    prompt, warm, frames = _inputs(dev, 2)
    state, _ = stream.prepare(warm, prompt, seed=2)
    state, _ = stream(state, frames[0])
    state_bytes = sum(t.numel() * t.element_size() for t in state_tensors(state))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    del state
    gc.collect()
    assert held - torch.cuda.memory_allocated() >= state_bytes
    state, _ = stream.prepare(warm, prompt, seed=2)
    assert stream._graphs.graphs == []
    state, _ = stream(state, frames[1])
    assert len(stream._graphs.graphs) == 1


def test_stream_burst_equals_replays(dev):
    stream = _stream(dev)
    prompt, warm, frames = _inputs(dev, 6)
    state_b, _ = stream.prepare(warm, prompt, seed=2)
    state_c, _ = stream.prepare(warm, prompt, seed=2)
    state_b, burst = stream.stream_burst(state_b, frames)
    outs = []
    for frame in frames:
        state_c, out = stream(state_c, frame)
        outs.append(out)
    assert torch.equal(burst, torch.stack(outs))
    _assert_twins(state_b, state_c)
