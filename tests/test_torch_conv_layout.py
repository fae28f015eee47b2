"""The cuDNN convs' weights are stored channels-last.

The port's convs hand ``F.conv2d`` a channels-last view of NHWC
activations; cuDNN runs such a conv channels-last and copies an OIHW weight
into that layout at every call (and every replay of a captured step). So
every ``nn.Conv2d`` the builder makes (the UNet's ``InflatedConv``, the
DPT's convs and ``StdConv``, the KL codec's convs, TAESD's end convs)
holds its weight channels-last, with the values an OIHW build draws from
the same seed, while TAESD's hand-written ``FusedConv3x3`` keeps OIHW. A
LoRA strength change and tp sharding keep the layout, and
``trace_summary()``'s ``conv_weight_relayouts`` reads 0 over ``prepare``
and two frames; an OIHW weight counts one a call.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import live2diff_tpu_torch.builder as builder
from _torch_checkpoints import TINY_OVERRIDES, config_without_paths, write_checkpoints
from _torch_parity import NARROW_DPT, TINY_UNET
from live2diff_tpu_torch.convert import checkpoint
from live2diff_tpu_torch.convert.checkpoint import build_module, channels_last_convs_
from live2diff_tpu_torch.models.midas import DPTConfig, StdConv
from live2diff_tpu_torch.models.resnet import InflatedConv
from live2diff_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from live2diff_tpu_torch.models.vae import FusedConv3x3, VAEConfig
from live2diff_tpu_torch.parallel.tp import shard_params
from live2diff_tpu_torch.utils.timing import RECORDER
from live2diff_tpu_torch.wrapper import WARMUP_FRAMES, StreamV2VWrapper

CL = torch.channels_last
H = W = 64
SEED = 3
CONFIG = {"num_inference_steps": 50, "t_index_list": [30, 40]}
OVERRIDES = dict(block_out_channels=(8, 16, 16, 16), attention_head_dim=2,
                 cross_attention_dim=768, norm_num_groups=4, motion_num_attention_heads=2)
NARROW_VAE = dict(block_out_channels=(8, 8, 16, 16), norm_num_groups=4)
# (codec, with the narrow DPT): the KL codec with the depth model holds
# every kind of cuDNN conv; TAESD holds the hand-written one
CASES = [("kl", True), ("taesd", False)]


def relayouts() -> int:
    return RECORDER.summary(0)["counters"].get("conv_weight_relayouts", 0)


def is_kxk(m: nn.Module) -> bool:
    return m.weight.shape[2] * m.weight.shape[3] > 1


@pytest.fixture
def narrow(monkeypatch):
    """``builder.py``'s DPT and KL codec at narrow widths."""
    monkeypatch.setattr(builder, "DPTConfig", lambda: DPTConfig(**NARROW_DPT))
    monkeypatch.setattr(builder, "VAEConfig", lambda: VAEConfig(**NARROW_VAE))


def _build(codec: str, depth: bool):
    return builder.build_pipeline(CONFIG, H, W, dtype=torch.float32, seed=SEED, device="cpu",
                                  use_depth=depth, use_tiny_vae=codec == "taesd",
                                  unet_overrides=OVERRIDES)


def _models(built):
    return {k: m for k, m in (("unet", built.unet), ("vae", built.vae),
                              ("depth", built.depth_model)) if m is not None}


@pytest.mark.parametrize("codec,depth", CASES)
def test_every_conv_weight_is_channels_last_with_the_oihw_builds_values(
        narrow, monkeypatch, codec, depth):
    ours = _models(_build(codec, depth))
    monkeypatch.setattr(checkpoint, "channels_last_convs_", lambda m: m)
    oihw = _models(_build(codec, depth))
    for name, model in ours.items():
        convs = {n: m for n, m in model.named_modules() if isinstance(m, nn.Conv2d)}
        kxk = [n for n, m in convs.items() if is_kxk(m)]
        assert kxk, name
        for n, m in convs.items():
            assert m.weight.is_contiguous(memory_format=CL), (name, n)
        ref = oihw[name].state_dict()
        for n, t in model.state_dict().items():
            assert t.dtype == ref[n].dtype and torch.equal(t, ref[n]), (name, n)
        # the OIHW build's k x k weights are not channels-last: the layout moved
        ref_convs = dict(oihw[name].named_modules())
        assert not any(ref_convs[n].weight.is_contiguous(memory_format=CL) for n in kxk), name
        for n, m in model.named_modules():
            if isinstance(m, FusedConv3x3):
                assert m.weight.is_contiguous() and not m.weight.is_contiguous(memory_format=CL)
    assert any(isinstance(m, FusedConv3x3) for m in ours["vae"].modules()) == (codec == "taesd")
    if depth:
        assert any(isinstance(m, StdConv) and is_kxk(m) for m in ours["depth"].modules())


@pytest.mark.parametrize("codec,depth", CASES)
def test_conv_weight_relayouts_read_zero_over_prepare_and_two_frames(
        narrow, monkeypatch, codec, depth):
    """Counted at every cuDNN conv of the UNet, the codec and the DPT; and,
    with the KL codec (no hand-written conv), every ``F.conv2d`` call with a
    k x k weight takes a channels-last input and a channels-last weight, so
    cuDNN copies neither."""
    w = StreamV2VWrapper(CONFIG, height=H, width=W, use_depth=depth,
                         use_tiny_vae=codec == "taesd", use_text_encoder=False,
                         output_type="np", dtype="float32", unet_overrides=OVERRIDES, seed=SEED,
                         device="cpu")
    calls = []
    conv2d = F.conv2d

    def recording(x, weight, *args, **kw):
        if weight.dim() == 4 and weight.shape[2] * weight.shape[3] > 1:
            calls.append((x.is_contiguous(memory_format=CL),
                          weight.is_contiguous(memory_format=CL)))
        return conv2d(x, weight, *args, **kw)

    if codec == "kl":
        monkeypatch.setattr(F, "conv2d", recording)
    frames = np.random.RandomState(2).randint(0, 256, (WARMUP_FRAMES + 2, H, W, 3)).astype(np.uint8)
    before = w.trace_summary()["counters"]["conv_weight_relayouts"]
    w.prepare("x", frames[:WARMUP_FRAMES])
    for f in frames[WARMUP_FRAMES:]:
        w(f)
    assert w.trace_summary()["counters"]["conv_weight_relayouts"] == before
    if codec == "kl":
        assert len(calls) > 100 and set(calls) == {(True, True)}


@pytest.mark.parametrize("kind", ["inflated", "stdconv", "partial_fp32"])
def test_an_oihw_weight_counts_one_relayout_a_call_and_a_channels_last_one_none(kind):
    torch.manual_seed(0)
    if kind == "stdconv":
        conv, x = StdConv(8, 16, 3, 1, 1, bias=False), torch.randn(2, 6, 6, 8)
    else:
        conv, x = InflatedConv(8, 16, 3, padding=1), torch.randn(1, 2, 6, 6, 8)
    run = conv.partial_fp32 if kind == "partial_fp32" else conv
    if kind == "partial_fp32":
        conv, x = conv.to(torch.bfloat16), x.to(torch.bfloat16)
    one_by_one = InflatedConv(8, 16, 1)  # [O, I, 1, 1] is channels-last as it is
    with torch.no_grad():
        n = relayouts()
        ref = run(x)
        one_by_one(torch.randn(1, 2, 6, 6, 8))
        assert relayouts() == n + 1
        channels_last_convs_(conv)
        assert conv.weight.is_contiguous(memory_format=CL)
        out = run(x)
        assert relayouts() == n + 1
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_update_lora_scale_keeps_the_layout(tmp_path):
    """The style LoRA writes a 3x3 conv (``conv_in``) in place: still
    channels-last, in the same memory, with the new values."""
    ckpt = write_checkpoints(tmp_path)
    w = StreamV2VWrapper(config_without_paths(ckpt), height=H, width=W, use_depth=False,
                         use_text_encoder=False, dtype="float32", unet_overrides=TINY_OVERRIDES,
                         device="cpu", output_type="np")
    conv_in = w.built.unet.conv_in.weight
    was, ptr = conv_in.detach().clone(), conv_in.data_ptr()
    assert w.update_lora_scale("style-lora.safetensors", 1.25) == 3
    assert conv_in.data_ptr() == ptr and not torch.equal(conv_in, was)
    for n, m in w.built.unet.named_modules():
        if isinstance(m, nn.Conv2d):
            assert m.weight.is_contiguous(memory_format=CL), n


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_params_keeps_the_layout(rank):
    """tp 2's slabs (cut without a process group: ``take_slab`` needs none)
    are channels-last again, and a row-sharded conv's bf16
    ``partial_fp32`` counts no relayout."""
    unet = build_module(lambda: UNet3DConditionModel(UNetConfig(**TINY_UNET)),
                        torch.device("cpu"), torch.bfloat16, torch.Generator().manual_seed(0))
    full = {n: m.weight.shape for n, m in unet.named_modules() if isinstance(m, nn.Conv2d)}
    layout = shard_params(unet, types.SimpleNamespace(tp=2, tp_rank=rank, tp_group=None))
    convs = {n: m for n, m in unet.named_modules() if isinstance(m, nn.Conv2d)}
    cut = [n for n, m in convs.items() if is_kxk(m) and m.weight.shape != full[n]]
    assert cut and all(f"{n}.weight" in layout.specs for n in cut)
    for n, m in convs.items():
        assert m.weight.is_contiguous(memory_format=CL), n
    conv2 = unet.down_blocks[0].resnets[0].conv2
    assert conv2.weight.shape[1] * 2 == full["down_blocks.0.resnets.0.conv2"][1]
    n = relayouts()
    with torch.no_grad():
        out = conv2.partial_fp32(torch.randn(1, 2, 8, 8, conv2.weight.shape[1], dtype=torch.bfloat16))
    assert out.dtype == torch.float32 and relayouts() == n
