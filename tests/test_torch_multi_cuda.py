"""MultiStream and the KL codec on the card: CUDA graph replays against the
eager steps, at a narrow width.

A 256x256 stream through the narrow UNet of tests/test_torch_graph_cuda.py
(TAESD, int8 or bf16 cache, no depth), two sessions. Both MultiStream
graphs (plain and masked) are captured when it is built; their replays
must equal the eager batched step bit for bit (the same kernels in the
same order on the same buffers, each session drawing from its own
generator). An idle session's generator is put back after a masked replay,
so the session then draws what a session that never idled draws; a slot
reseeded by ``prepare_session`` (``set_state`` on a generator the graphs
hold) is seen by the next replay; and a round launches each kernel as many
times as one single-session step. These need an NVIDIA Hopper GPU and
``nvcc``; without a CUDA device each test skips. On the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_multi_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from live2diff_tpu_torch.ops import _build
from live2diff_tpu_torch.stream.graph import state_tensors

pytestmark = pytest.mark.cuda

SIZE, S = 256, 2
NARROW_UNET = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=2,
                   cross_attention_dim=64, norm_num_groups=8, motion_num_attention_heads=2)
CONFIG = {"num_inference_steps": 50, "t_index_list": [30, 40]}
SEEDS = (3, 4)
# None: every session active; else the active mask of a masked round
ROUNDS = (None, None, (True, False), (True, False), None, (False, True), None, None)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _stream(dev, cache="int8", **kw):
    from live2diff_tpu_torch.builder import build_pipeline

    return build_pipeline(CONFIG, SIZE, SIZE, dtype=torch.bfloat16, kv_cache_dtype=cache,
                          output_uint8=True, seed=0, device=dev, unet_overrides=NARROW_UNET,
                          use_depth=False, **kw).stream


def _inputs(dev, rounds, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompts = torch.randn(S, 77, 64, generator=gen, device=dev)
    warm = torch.rand(S, 8, SIZE, SIZE, 3, generator=gen, device=dev) * 2 - 1
    frames = torch.randint(0, 256, (rounds, S, SIZE, SIZE, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    return prompts, warm, frames


def _multi(stream, prompts, warm, seeds=SEEDS):
    from live2diff_tpu_torch.stream.multi import MultiStream

    multi = MultiStream(stream, S)
    states, _ = multi.prepare(warm, prompts, seeds=seeds)
    return multi, states


def _assert_twins(a, b):
    assert a.frame_idx == b.frame_idx
    for x, y in zip(state_tensors(a), state_tensors(b)):
        assert torch.equal(x, y)
    for x, y in zip(a.generator, b.generator):
        assert torch.equal(x.get_state(), y.get_state())


@pytest.mark.parametrize("cache", ["int8", "bf16"])
def test_plain_and_masked_replays_equal_the_eager_step(dev, cache):
    stream = _stream(dev, cache)
    prompts, warm, frames = _inputs(dev, len(ROUNDS))
    graph_multi, states_g = _multi(stream, prompts, warm)
    eager_multi, states_e = _multi(stream, prompts, warm)
    assert set(graph_multi._graphs) == {(False, torch.uint8), (True, torch.uint8)}
    for r, (frame, active) in enumerate(zip(frames, ROUNDS)):
        states_g, out_g = graph_multi(states_g, frame, active)
        states_e, out_e = eager_multi._round(states_e, frame, active, None, replay=False)
        assert torch.equal(out_g, out_e), f"round {r}"
    _assert_twins(states_g, states_e)
    assert len(graph_multi._graphs) == 2  # nothing captured after construction


def test_idle_generator_is_restored_under_replay(dev):
    """A masked replay leaves the idle session's generator and tensors as
    they were; fed again, that session's outputs equal, bit for bit, those
    of a session that never idled (a second MultiStream whose slot 1 gets
    the same frames without the idle round)."""
    stream = _stream(dev)
    prompts, warm, frames = _inputs(dev, 4, seed=1)
    a, states_a = _multi(stream, prompts, warm)
    b, states_b = _multi(stream, prompts, warm)
    states_a, _ = a(states_a, frames[0])
    states_b, _ = b(states_b, frames[0])
    before = [t[1].clone() for t in state_tensors(states_a)]
    gen_before = states_a.generator[1].get_state()
    states_a, _ = a(states_a, frames[1], active=[True, False])
    assert torch.equal(gen_before, states_a.generator[1].get_state())
    assert all(torch.equal(x, y[1]) for x, y in zip(before, state_tensors(states_a)))
    for frame in frames[2:]:
        states_a, out_a = a(states_a, frame)
        states_b, out_b = b(states_b, frame)
        assert torch.equal(out_a[1], out_b[1])
    for x, y in zip(state_tensors(states_a), state_tensors(states_b)):
        assert torch.equal(x[1], y[1])


def test_reseeded_slot_is_seen_by_the_next_replay(dev):
    """prepare_session on a slot reseeds the generator the graphs hold, in
    place: the next replay's slot 0 equals a fresh MultiStream's slot 0
    warmed from the same seed and frames."""
    stream = _stream(dev)
    prompts, warm, frames = _inputs(dev, 3, seed=2)
    a, states_a = _multi(stream, prompts, warm)
    for frame in frames[:2]:
        states_a, _ = a(states_a, frame)
    states_a, _ = a.prepare_session(states_a, 0, warm[1], prompts[1], seed=9)
    b, states_b = _multi(stream, torch.stack([prompts[1], prompts[1]]),
                         torch.stack([warm[1], warm[1]]), seeds=(9, 9))
    states_a, out_a = a(states_a, frames[2])
    states_b, out_b = b(states_b, frames[2])
    assert torch.equal(out_a[0], out_b[0])


def test_a_round_launches_each_kernel_as_one_single_step(dev):
    """Counted through the wrappers at capture: building a MultiStream runs
    two eager warm rounds (plain, masked) and captures two, so four rounds
    launch four single-session steps' worth of each kernel."""
    from live2diff_tpu_torch.stream.multi import MultiStream

    stream = _stream(dev)
    prompts, warm, frames = _inputs(dev, 1)
    state, _ = stream.prepare(warm[0], prompts[0][None], seed=2)
    _build.reset_launch_counts()
    stream.capture_step(state, torch.uint8)  # the warm step and one capture
    single = {k: v // 2 for k, v in _build.launch_counts.items()}
    assert single["stream_attention_int8"] == 40 and single["conv3x3"]
    _build.reset_launch_counts()
    MultiStream(stream, S)
    assert dict(_build.launch_counts) == {k: 4 * v for k, v in single.items()}


def test_kl_codec_step_captured_equals_eager(dev):
    """use_tiny_vae=False: the KL codec (cuDNN convs, fp32 GroupNorms, the
    one-head mid-block attention) inside the captured step, replays equal
    to the eager step bit for bit; no TAESD conv kernel launches."""
    stream = _stream(dev, use_tiny_vae=False)
    prompts, warm, frames = _inputs(dev, 6, seed=3)
    state_g, _ = stream.prepare(warm[0], prompts[0][None], seed=2)
    state_e, _ = stream.prepare(warm[0], prompts[0][None], seed=2)
    _build.reset_launch_counts()
    for i, frame in enumerate(frames[:, 0]):
        state_g, out_g = stream(state_g, frame)
        state_e, out_e = stream._frame_step(state_e, frame, stream._prompt_embeds)
        assert torch.equal(out_g, out_e), f"frame {i}"
        assert out_g.shape == (SIZE, SIZE, 3) and out_g.dtype == torch.uint8
    for x, y in zip(state_tensors(state_g), state_tensors(state_e)):
        assert torch.equal(x, y)
    assert _build.launch_counts["conv3x3"] == _build.launch_counts["conv3x3_s2"] == 0
    assert _build.launch_counts["stream_attention_int8"]
