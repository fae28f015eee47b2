"""The captured stream step on the card with the cuDNN convs' weights
channels-last, against the same step built with OIHW weights.

A 256x256 stream through a narrow UNet (bf16, bf16 cache, TAESD, no depth
model), built twice from one seed: once as the builder lays the weights out
(``convert/checkpoint.py:channels_last_convs_``) and once with that step
left out. cuDNN gets the same descriptors and data either way, so every
frame is bit-equal; with OIHW weights cuDNN copies each k x k weight into
the channels-last layout at every replay, one device kernel a conv, which
``conv_weight_relayouts`` counts at capture. These need an NVIDIA GPU and
``nvcc``; without a CUDA device each test skips. Run them on the card, from
the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_conv_layout_cuda.py
"""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from live2diff_tpu_torch.convert import checkpoint
from live2diff_tpu_torch.utils.timing import RECORDER

pytestmark = pytest.mark.cuda

SIZE = 256
NARROW_UNET = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=2,
                   cross_attention_dim=64, norm_num_groups=8, motion_num_attention_heads=2)
CONFIG = {"num_inference_steps": 50, "t_index_list": [30, 40]}
FRAMES = 12
PROFILED = 3


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def relayouts() -> int:
    return RECORDER.summary(0)["counters"].get("conv_weight_relayouts", 0)


def _stream(dev):
    from live2diff_tpu_torch.builder import build_pipeline

    return build_pipeline(CONFIG, SIZE, SIZE, dtype=torch.bfloat16, kv_cache_dtype="bf16",
                          output_uint8=True, seed=0, device=dev, unet_overrides=NARROW_UNET,
                          use_depth=False).stream


def _kernels_a_call(fn) -> float:
    """Device kernels a call of ``fn`` (a replay and its copies), from the
    profiler over ``PROFILED`` calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n / PROFILED


def test_channels_last_weights_replay_bit_equal_with_one_kernel_fewer_a_relaid_conv(
        dev, monkeypatch):
    ours = _stream(dev)
    with monkeypatch.context() as mp:
        mp.setattr(checkpoint, "channels_last_convs_", lambda m: m)
        oihw = _stream(dev)
    kxk = [m for m in oihw.unet.modules() if isinstance(m, torch.nn.Conv2d)
           and m.weight.shape[2] * m.weight.shape[3] > 1]
    assert len(kxk) == 60 and not any(m.weight.is_contiguous(memory_format=torch.channels_last)
                                     for m in kxk)
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.randn(1, 77, 64, generator=gen, device=dev)
    warm = torch.rand(8, SIZE, SIZE, 3, generator=gen, device=dev) * 2 - 1
    frames = torch.randint(0, 256, (FRAMES, SIZE, SIZE, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    state_c, out_c = ours.prepare(warm, prompt, seed=2)
    state_o, out_o = oihw.prepare(warm, prompt, seed=2)
    assert torch.equal(out_c, out_o)

    # an eager step each, then the first calls capture: each counts a step
    n = relayouts()
    ours.warm_frame_step(frames.dtype)
    assert relayouts() == n
    oihw.warm_frame_step(frames.dtype)
    per_step = relayouts() - n
    assert per_step >= len(kxk)
    state_c, out_c = ours(state_c, frames[0])
    state_o, out_o = oihw(state_o, frames[0])
    assert relayouts() == n + 2 * per_step
    assert torch.equal(out_c, out_o)
    for i, frame in enumerate(frames[1:], start=1):
        state_c, out_c = ours(state_c, frame)
        state_o, out_o = oihw(state_o, frame)
        assert torch.equal(out_c, out_o), f"frame {i}"

    box = {}

    def call(stream, key, state):
        box[key], _ = stream(box.get(key, state), frames[-1])

    k_c = _kernels_a_call(lambda: call(ours, "c", state_c))
    k_o = _kernels_a_call(lambda: call(oihw, "o", state_o))
    assert k_o - k_c == per_step, (k_o, k_c, per_step)
