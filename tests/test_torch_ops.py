"""The port's ops against the JAX package's: attention (with the s-major and
int8-QK flash variants), convs, LayerNorm, GroupNorm, int8 quantisation.

On the CPU each kernel wrapper runs its plain torch version; these tests
hold that version (and the op around it) against the JAX function on the
same numpy inputs, and against the JAX package's Pallas kernel run in
interpret mode, at small shapes. All in fp32, where the two frameworks
differ only in summation order: tolerances are a few fp32 ulps of the
accumulated sums (1e-5 relative, 1e-4 where the Pallas kernel reassociates
the head reduction through a mask matmul).
"""

from __future__ import annotations

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import live2diff_tpu.ops.attention as jattn
import live2diff_tpu.ops.norm as jnorm
from _torch_norm_shapes import GN_CODEC_SHAPES
from _torch_parity import rel_err
from live2diff_tpu.models.motion import _quantize_kv as jax_quantize_kv
from live2diff_tpu.ops.conv import conv3x3_fused, conv3x3_s2_fused
from live2diff_tpu.ops.flash_attention import flash_self_attention as jax_flash_smajor
from live2diff_tpu.ops.flash_attention import flash_self_attention_dmajor
from live2diff_tpu.ops.flash_attention import flash_self_attention_int8 as jax_flash_int8
from live2diff_tpu.ops.flash_attention import pick_block as jax_pick_block
from live2diff_tpu.ops.norm import _layer_norm_kernel
from live2diff_tpu.ops.norm import layer_norm as jax_layer_norm
from live2diff_tpu.ops.stream_attention import (
    stream_window_attention_kernel, stream_window_attention_kernel_int8,
)
from live2diff_tpu_torch.models.motion import _quantize_kv
from live2diff_tpu_torch.ops import _build
from live2diff_tpu_torch.ops import attention as tattn
from live2diff_tpu_torch.ops import norm as tnorm
from live2diff_tpu_torch.ops.choices import KernelChoices
from live2diff_tpu_torch.ops.conv import conv3x3
from live2diff_tpu_torch.ops.flash_attention import (
    flash_self_attention, flash_self_attention_int8, pick_block, quantize_groups,
)
from live2diff_tpu_torch.ops.norm import layer_norm
from live2diff_tpu_torch.ops.stream_attention import (
    plan, stream_window_attention_bf16, stream_window_attention_int8,
)

T = torch.from_numpy


def _stream_inputs(rs, s=2, hw=64, heads=4, dh=8, window=16, cache="fp32"):
    c = heads * dh
    q = rs.randn(s, hw, c).astype(np.float32)
    pe_q = rs.randn(s, c).astype(np.float32)
    pe_k = rs.randn(s, window, c).astype(np.float32)
    pe_v = rs.randn(s, window, c).astype(np.float32)
    # -inf on masked slots; the 8 sink slots always visible
    bias = np.where(rs.rand(s, window) > 0.4, 0.0, -np.inf).astype(np.float32)
    bias[:, :8] = 0.0
    if cache == "int8":
        data = rs.randint(-127, 128, size=(s, 2, window, c, hw)).astype(np.int8)
        scales = (0.005 + 0.02 * rs.rand(s, 2, window, c)).astype(np.float32)
        kv = (data, scales)
    else:
        kv = rs.randn(s, 2, window, c, hw).astype(np.float32)
    return q, kv, pe_q, pe_k, pe_v, bias, heads


def _bf16_pair(arr):
    """One fp32 numpy array as a bf16 array on each side; both round to
    nearest even, so the two hold the same values."""
    jarr, tarr = jnp.asarray(arr).astype(jnp.bfloat16), T(arr).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(jarr.astype(jnp.float32)), tarr.float().numpy())
    return jarr, tarr


# The bf16 case keeps q and the PE rows in fp32 and stores the cache in bf16
# on both sides: the same rounded cache values meet the same fp32 math, so
# the fp32 tolerance holds unchanged (the cache's own bf16 rounding, ~2^-9
# relative, is common to both and cancels from the comparison). The ids
# False / True name the fp32 and int8 cases, as whether the cache is int8.
@pytest.mark.parametrize("cache", ["fp32", "int8", "bf16"], ids=["False", "True", "bf16"])
def test_stream_window_attention_matches_jax(cache):
    q, kv, pe_q, pe_k, pe_v, bias, heads = _stream_inputs(np.random.RandomState(1), cache=cache)
    if cache == "int8":
        jcache, tcache = tuple(map(jnp.asarray, kv)), tuple(map(T, kv))
    elif cache == "bf16":
        jcache, tcache = _bf16_pair(kv)
    else:
        jcache, tcache = jnp.asarray(kv), T(kv)
    ref = jattn.stream_window_attention(
        jnp.asarray(q), jcache, jnp.asarray(pe_q), jnp.asarray(pe_k), jnp.asarray(pe_v),
        jnp.asarray(bias), heads,
    )
    out = tattn.stream_window_attention(T(q), tcache, T(pe_q), T(pe_k), T(pe_v), T(bias), heads)
    assert out.shape == q.shape
    assert rel_err(out.numpy(), ref) < 1e-5


def _kernel_args(q, pe_q, pe_k, bias, heads):
    """(q_full, extra, scale) as ops/attention.py hands them to the kernels."""
    s, hw, c = q.shape
    scale = (c // heads) ** -0.5
    q_full = q + pe_q[:, None, :]
    extra = np.einsum(
        "sphd,swhd->swhp", q_full.reshape(s, hw, heads, -1), pe_k.reshape(s, 16, heads, -1)
    ) * scale + bias[:, :, None, None]
    return q_full, extra.astype(np.float32), scale


# HW = 128, and the odd latent levels of tests/test_torch_nonsquare.py (96,
# 24), which are no multiple of the kernel's 128-position int8 tile
@pytest.mark.parametrize("hw", [128, 96, 24])
def test_stream_attention_int8_plain_matches_pallas_interpret(hw):
    """Kernel #1's plain version == the Pallas int8 kernel (interpret mode)."""
    rs = np.random.RandomState(2)
    q, (data, scales), pe_q, pe_k, pe_v, bias, heads = _stream_inputs(rs, hw=hw, cache="int8")
    q_full, extra, scale = _kernel_args(q, pe_q, pe_k, bias, heads)
    with pltpu.force_tpu_interpret_mode():
        ref = stream_window_attention_kernel_int8(
            jnp.asarray(q_full.transpose(0, 2, 1)), jnp.asarray(data), jnp.asarray(extra),
            jnp.asarray(pe_v.transpose(0, 2, 1)), jnp.asarray(scales[:, 0].transpose(0, 2, 1)),
            jnp.asarray(scales[:, 1].transpose(0, 2, 1)), scale=scale, heads=heads,
        )
    out = stream_window_attention_int8(
        T(q_full), T(data), T(scales), T(extra), T(pe_v), scale, heads
    )
    assert rel_err(out.numpy(), np.asarray(ref).transpose(0, 2, 1)) < 1e-4


@pytest.mark.parametrize("hw", [128, 96, 24])
def test_stream_attention_bf16_plain_matches_pallas_interpret(hw):
    """Kernel #2's plain version == the Pallas bf16-cache kernel (interpret
    mode): an fp32 query over the same bf16 cache on both sides. 1e-4: the
    Pallas kernel reassociates the head reduction through a mask matmul."""
    rs = np.random.RandomState(9)
    q, kv, pe_q, pe_k, pe_v, bias, heads = _stream_inputs(rs, hw=hw, cache="bf16")
    q_full, extra, scale = _kernel_args(q, pe_q, pe_k, bias, heads)
    jcache, tcache = _bf16_pair(kv)
    with pltpu.force_tpu_interpret_mode():
        ref = stream_window_attention_kernel(
            jnp.asarray(q_full.transpose(0, 2, 1)), jcache, jnp.asarray(extra),
            jnp.asarray(pe_v.transpose(0, 2, 1)), scale=scale, heads=heads,
        )
    out = stream_window_attention_bf16(T(q_full), tcache, T(extra), T(pe_v), scale, heads)
    assert rel_err(out.numpy(), np.asarray(ref).transpose(0, 2, 1)) < 1e-4


# (steps, HW, C, heads, bytes a cache element) -> (staging, cluster) on a
# 132-SM card: the four UNet levels of both rows, int8 and bf16 caches, and
# the ragged card-test shapes
@pytest.mark.parametrize("shape,route", [
    ((2, 4096, 320, 8, 1), ("tma", 1)), ((2, 1024, 640, 8, 1), ("tma", 2)),
    ((2, 256, 1280, 8, 1), ("tma", 5)), ((2, 64, 1280, 8, 1), ("tma", 7)),
    ((2, 6144, 320, 8, 1), ("tma", 1)), ((2, 1536, 640, 8, 1), ("tma", 1)),
    ((2, 384, 1280, 8, 1), ("tma", 3)), ((2, 96, 1280, 8, 1), ("tma", 7)),
    ((2, 4096, 320, 8, 2), ("tma", 1)), ((2, 1024, 640, 8, 2), ("tma", 1)),
    ((2, 256, 1280, 8, 2), ("tma", 3)), ((2, 64, 1280, 8, 2), ("tma", 7)),
    ((2, 100, 320, 8, 1), ("scalar", 5)), ((1, 33, 64, 2, 2), ("scalar", 4)),
    ((3, 7, 16, 1, 1), ("scalar", 2)), ((2, 24, 320, 8, 1), ("scalar", 5)),
    ((2, 24, 320, 8, 2), ("tma", 5)), ((2, 100, 8, 1, 1), ("scalar", 1)),
])
def test_stream_attention_route_plan(shape, route):
    """The staging route follows the channel stride (HW x element bytes a
    multiple of 16); a cluster splits the head's 8-channel chunks only where
    the tiles alone would leave SMs idle, never past one chunk a CTA, and
    no wider than the same most chunks a CTA needs."""
    assert plan(*shape) == route
    steps, hw, c, heads, nbytes = shape
    cluster = route[1]
    chunks = -(-(c // heads) // 8)
    ctas = steps * heads * -(-hw // (128 // nbytes))
    assert cluster <= min(8, chunks)
    assert (cluster == 1) == (ctas >= 132 or chunks == 1)
    if cluster > 1:
        assert -(-chunks // (cluster - 1)) > -(-chunks // cluster)


def test_stream_attention_plan_takes_misaligned_caches_by_elements():
    assert plan(2, 4096, 320, 8, 1, aligned=False) == ("scalar", 1)


# The JAX gate (live2diff_tpu/ops/norm.py:239-246) sends a LayerNorm to its
# kernel only with C % 8 == 0 and at least 2^14 elements, at a chosen site;
# the port's route sends the same calls to its kernel when they are bf16 on
# the card (this fp32 CPU call itself runs the plain version).
@pytest.mark.parametrize("rows,c,site,taken", [
    (64, 320, "spatial", True),      # 20480 elements: the kernel
    (13, 1280, "spatial", True),     # 16640 elements at the UNet's widest C
    (32, 320, "spatial", False),     # 10240 < 2^14: plain
    (51, 320, "spatial", False),     # 16320 < 2^14: plain
    (256, 68, "spatial", False),     # C % 8 != 0: plain
    (16, 1280, "temporal", False),   # the site is not chosen
])
def test_layer_norm_gate_matches_jax(monkeypatch, rows, c, site, taken):
    monkeypatch.setattr(jattn, "_BACKEND", "tpu")
    monkeypatch.setattr(jnorm, "_LN_SITE_TAGS", {"spatial"})
    jax_calls, port_calls = [], []
    real_j, real_t = jnorm._layer_norm_kernel, tnorm.layer_norm_rows
    monkeypatch.setattr(jnorm, "_layer_norm_kernel",
                        lambda *a, **kw: (jax_calls.append(1), real_j(*a, **kw))[1])
    monkeypatch.setattr(tnorm, "layer_norm_rows",
                        lambda *a, **kw: (port_calls.append(1), real_t(*a, **kw))[1])
    rs = np.random.RandomState(18)
    x = (rs.randn(rows, c) * 2 + 1).astype(np.float32)
    g, b = (1 + 0.1 * rs.randn(c)).astype(np.float32), (0.1 * rs.randn(c)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jnorm.layer_norm(*map(jnp.asarray, (x, g, b)), eps=1e-5, site=site)
    kernels = KernelChoices(ln_kernel_sites={"spatial"})
    out = tnorm.layer_norm(T(x), T(g), T(b), eps=1e-5, site=site, kernels=kernels)
    on_card = tnorm.ln_route(x.size, c, torch.bfloat16, "cuda", False, site, kernels)
    assert len(jax_calls) == int(taken)
    assert on_card == ("ln_kernel" if taken else "ln_plain") and port_calls == []
    assert rel_err(out.numpy(), ref) < 1e-5


# LayerNorm in fp32: both sides take the same centred two-pass statistics,
# so only summation order differs (1e-5 relative). 77 and 37 rows are not
# multiples of the Pallas kernel's 16-row block: its padded tail is run.
@pytest.mark.parametrize("rows,c,site", [(77, 64, "vit"), (37, 16, "vit"), (77, 64, "spatial")])
def test_layer_norm_matches_jax(rows, c, site):
    rs = np.random.RandomState(10)
    x = (rs.randn(rows, c) * 2.0 + 3.0).astype(np.float32)  # |mean| > std
    g = (1.0 + 0.1 * rs.randn(c)).astype(np.float32)
    b = (0.05 * rs.randn(c)).astype(np.float32)
    ref = jax_layer_norm(*map(jnp.asarray, (x, g, b)), eps=1e-6, site=site)
    out = layer_norm(T(x), T(g), T(b), eps=1e-6, site=site)
    assert out.shape == x.shape
    assert rel_err(out.numpy(), ref) < 1e-5


@pytest.mark.parametrize("rows,c", [(77, 64), (37, 16), (20, 768)])
def test_layer_norm_plain_matches_pallas_interpret(rows, c):
    """Kernel #9's plain version == the Pallas LayerNorm kernel."""
    rs = np.random.RandomState(11)
    x = (rs.randn(rows, c) + 1.0).astype(np.float32)
    g = (1.0 + 0.1 * rs.randn(c)).astype(np.float32)
    b = (0.05 * rs.randn(c)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = _layer_norm_kernel(*map(jnp.asarray, (x, g, b)), eps=1e-6)
    out = layer_norm(T(x), T(g), T(b), eps=1e-6, site="vit")
    assert rel_err(out.numpy(), ref) < 1e-5


@pytest.mark.parametrize("shape_q,shape_k", [
    ((2, 64, 2, 8), (2, 64, 2, 8)),  # spatial self-attention, Sq == Sk
    ((2, 64, 2, 8), (2, 77, 2, 8)),  # cross-attention over 77 text tokens
    ((1, 16, 8, 2, 8), (1, 16, 8, 2, 8)),  # warmup motion attention, rank 5
])
def test_dot_product_attention_matches_jax(shape_q, shape_k):
    rs = np.random.RandomState(3)
    q = rs.randn(*shape_q).astype(np.float32)
    k = rs.randn(*shape_k).astype(np.float32)
    v = rs.randn(*shape_k).astype(np.float32)
    ref = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = tattn.dot_product_attention(T(q), T(k), T(v))
    assert out.shape == q.shape
    assert rel_err(out.numpy(), ref) < 1e-5


def test_dot_product_attention_with_bias_matches_jax():
    rs = np.random.RandomState(4)
    q, k, v = (rs.randn(2, 32, 2, 8).astype(np.float32) for _ in range(3))
    bias = np.where(rs.rand(2, 2, 32, 32) > 0.3, 0.0, -np.inf).astype(np.float32)
    bias[..., 0] = 0.0
    ref = jattn.dot_product_attention(*map(jnp.asarray, (q, k, v)), bias=jnp.asarray(bias))
    out = tattn.dot_product_attention(T(q), T(k), T(v), bias=T(bias))
    assert rel_err(out.numpy(), ref) < 1e-5


def test_flash_plain_matches_pallas_dmajor_interpret():
    """Kernel #2's plain version == the Pallas d-major flash kernel."""
    rs = np.random.RandomState(5)
    b, h, s, d = 2, 2, 256, 40
    q, k, v = (rs.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        ref = flash_self_attention_dmajor(
            *map(jnp.asarray, (q, k, v)), scale=d**-0.5, block_q=128, block_k=128
        )
    out = tattn.dot_product_attention(*(T(x.transpose(0, 2, 1, 3).copy()) for x in (q, k, v)))
    assert rel_err(out.numpy().transpose(0, 2, 1, 3), ref) < 1e-5


def _conv_ref(x, w_hwio, b, skip, relu, stride):
    out = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w_hwio), (stride, stride), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    if b is not None:
        out = out + b
    if skip is not None:
        out = out + skip
    return np.asarray(jnp.maximum(out, 0.0) if relu else out)


@pytest.mark.parametrize("stride,cin,skip,relu", [
    (1, 16, True, True), (1, 16, False, False), (1, 3, False, True),
    (2, 16, False, False), (2, 16, False, True),
])
def test_conv3x3_matches_jax(stride, cin, skip, relu):
    rs = np.random.RandomState(6)
    x = rs.randn(2, 16, 24, cin).astype(np.float32)
    w = (0.1 * rs.randn(3, 3, cin, 16)).astype(np.float32)
    b = rs.randn(16).astype(np.float32)
    ho, wo = 16 // stride, 24 // stride
    sk = rs.randn(2, ho, wo, 16).astype(np.float32) if skip else None
    ref = _conv_ref(x, w, b, sk, relu, stride)
    out = conv3x3(T(x), T(w.transpose(3, 2, 0, 1).copy()), T(b),
                  None if sk is None else T(sk), relu, stride)
    assert out.shape == ref.shape
    assert rel_err(out.numpy(), ref) < 1e-5


@pytest.mark.parametrize("stride", [1, 2])
def test_conv3x3_plain_matches_pallas_interpret(stride):
    """Kernels #6 and #7's plain version == the Pallas fused convs."""
    rs = np.random.RandomState(7)
    x = rs.randn(1, 16, 128, 64).astype(np.float32)
    w = (0.1 * rs.randn(3, 3, 64, 64)).astype(np.float32)
    b = rs.randn(64).astype(np.float32)
    skip = rs.randn(1, 16, 128, 64).astype(np.float32) if stride == 1 else None
    with pltpu.force_tpu_interpret_mode():
        if stride == 1:
            ref = conv3x3_fused(*map(jnp.asarray, (x, w, b)), skip=jnp.asarray(skip),
                                relu=True, block_h=8)
        else:
            ref = conv3x3_s2_fused(*map(jnp.asarray, (x, w, b)), block_h=8)
    out = conv3x3(T(x), T(w.transpose(3, 2, 0, 1).copy()), T(b),
                  None if skip is None else T(skip), stride == 1, stride)
    assert rel_err(out.numpy(), ref) < 1e-4


@pytest.mark.parametrize("layout,dim", [((2, 64, 16), 1), ((64, 8, 16), 0)])
def test_quantize_kv_matches_jax_exactly(layout, dim):
    """Exact int8 codes and scales on inputs kept away from the .5 rounding
    boundary (|fraction - .5| >= 0.1), so no fp32 rounding difference can
    flip a code."""
    rs = np.random.RandomState(8)
    chan_scale = 0.01 + rs.rand(*[1 if i == dim else n for i, n in enumerate(layout)])
    codes = rs.randint(-126, 127, size=layout).astype(np.float32)
    frac = rs.uniform(-0.4, 0.4, size=layout).astype(np.float32)
    x = (codes + frac) * chan_scale
    # pin each channel's absmax to exactly 127 * scale
    idx = [slice(None)] * len(layout)
    idx[dim] = 0
    x[tuple(idx)] = 127.0 * np.take(chan_scale, 0, axis=dim)
    x = x.astype(np.float32)
    jq, js = jax_quantize_kv(jnp.asarray(x), (dim,))
    tq, ts = _quantize_kv(T(x), dim)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.abs(tq.numpy().astype(int)).max() == 127


# ---------------------------------------------------------------------------
# the opt-in kernels: s-major flash (#4), int8-QK flash (#5), GroupNorm (#8)
# ---------------------------------------------------------------------------


def test_flash_smajor_plain_matches_pallas_interpret():
    """Kernel #4's plain version == the Pallas s-major flash kernel, with
    two key blocks and two query blocks. fp32 on both sides: the same
    blocked online softmax, summed in another order (1e-5 relative)."""
    rs = np.random.RandomState(12)
    b, h, s, d = 2, 2, 256, 40
    q, k, v = (rs.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash_smajor(*map(jnp.asarray, (q, k, v)), scale=d**-0.5, block_q=128,
                               block_k=128)
    out = flash_self_attention(T(q), T(k), T(v), d**-0.5, block_q=128, block_k=128)
    assert out.shape == q.shape
    assert rel_err(out.numpy(), ref) < 1e-5


def test_flash_int8_plain_matches_pallas_interpret():
    """Kernel #5's plain version == the Pallas int8-QK flash kernel, with 4
    query groups and 2 key groups. Both quantise with the same groups, the
    same reciprocal and half-to-even rounding, so the int8 codes are equal
    and the integer Q.K exact on both sides; what is left is fp32 summation
    order in the softmax and P.V (1e-5 relative, where the int8 noise
    against unquantised attention is ~1e-2). K carries a mean offset, so
    its scales differ from Q's."""
    rs = np.random.RandomState(13)
    b, h, s, d = 2, 2, 512, 40
    q = rs.randn(b, h, s, d).astype(np.float32)
    k = (rs.randn(b, h, s, d) + 0.7).astype(np.float32)
    v = rs.randn(b, h, s, d).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash_int8(*map(jnp.asarray, (q, k, v)), scale=d**-0.5, block_q=128,
                             block_k=256)
    out = flash_self_attention_int8(T(q), T(k), T(v), d**-0.5, block_q=128, block_k=256)
    assert rel_err(out.numpy(), ref) < 1e-5
    # and the codes are the quantisation the function names: 4 q groups
    codes, scales = quantize_groups(T(q), 128)
    assert scales.shape == (b, h, 4) and codes.abs().max() == 127
    np.testing.assert_array_equal(codes.numpy(), np.round(codes.numpy()))


def test_pick_block_matches_jax():
    for s, target in [(6144, 4096), (6144, 1024), (1536, 1024), (1536, 512), (4096, 4096),
                      (1024, 1024), (96, 512), (2816, 1024), (6144, 512), (1536, 1536)]:
        assert pick_block(s, target) == jax_pick_block(s, target), (s, target)


@pytest.mark.parametrize("variant", ["smajor", "int8"])
def test_dot_product_attention_variants_match_jax(monkeypatch, variant):
    """dot_product_attention at S = 1024 (the gate passes) with a flash
    variant == the JAX dispatch of LIVE2DIFF_FLASH=<variant> to its Pallas
    kernel in interpret mode, blocks included (int8: block_k = min(S, 4096))."""
    monkeypatch.setattr(jattn, "_BACKEND", "tpu")
    monkeypatch.setenv("LIVE2DIFF_FLASH", variant)
    rs = np.random.RandomState(14)
    q, k, v = (rs.randn(1, 1024, 2, 8).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        ref = jattn.dot_product_attention(*map(jnp.asarray, (q, k, v)))
    out = tattn.dot_product_attention(T(q), T(k), T(v), flash_variant=variant)
    assert out.shape == q.shape
    assert rel_err(out.numpy(), ref) < 1e-5


@pytest.mark.parametrize("shape_q,shape_k,taken", [
    ((2, 1024, 2, 8), (2, 1024, 2, 8), True),     # the 32x32 level's self-attention
    ((1, 1536, 2, 8), (1, 1536, 2, 8), True),     # 768x512's 32x48 level
    ((2, 1024, 2, 8), (2, 77, 2, 8), False),      # cross-attention
    ((2, 256, 2, 8), (2, 256, 2, 8), False),      # below 1024
    ((1, 577, 2, 8), (1, 577, 2, 8), False),      # the ViT: not a multiple of 128
    ((1, 2, 1024, 2, 8), (1, 2, 1024, 2, 8), False),  # rank 5
])
def test_flash_variant_gate(monkeypatch, shape_q, shape_k, taken):
    """A variant takes exactly the calls that pass the JAX flash gate;
    every other call keeps the d-major path."""
    calls = []
    real = tattn.flash_self_attention_int8
    monkeypatch.setattr(tattn, "flash_self_attention_int8",
                        lambda *a, **kw: (calls.append(a[0].shape), real(*a, **kw))[1])
    rs = np.random.RandomState(15)
    q = T(rs.randn(*shape_q).astype(np.float32))
    k, v = (T(rs.randn(*shape_k).astype(np.float32)) for _ in range(2))
    out = tattn.dot_product_attention(q, k, v, flash_variant="int8")
    assert out.shape == q.shape
    assert len(calls) == int(taken)
    if not taken:
        ref = tattn.dot_product_attention(q, k, v)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)


# GroupNorm: the JAX test's cases (tests/test_attention_ops.py:310). Both
# sides take the same centred two-pass fp32 statistics; only summation order
# differs (1e-5 relative).
@pytest.mark.parametrize("b,t,c,act", [(2, 64, 320, "silu"), (3, 128, 64, "relu"),
                                       (2, 96, 1280, "none")])
def test_group_norm_matches_pallas_interpret(monkeypatch, b, t, c, act):
    """The port's GroupNorm kernel wrapper (on the CPU its plain version) ==
    the JAX group_norm_act dispatched to the Pallas kernel (interpret mode),
    with JAX's site gate lifted; the JAX dispatch is shown to take the
    kernel, and the port's route to take its kernel on a bf16 card call."""
    monkeypatch.setattr(jnorm, "_GN_SITE_TAGS", set())
    monkeypatch.setattr(jattn, "_BACKEND", "tpu")
    jax_calls = []
    real_j = jnorm._group_norm_kernel
    monkeypatch.setattr(jnorm, "_group_norm_kernel",
                        lambda *a, **kw: (jax_calls.append(1), real_j(*a, **kw))[1])
    rs = np.random.RandomState(16)
    x = (rs.randn(b, t, c) * 3 + 1).astype(np.float32)
    g, bt = rs.randn(c).astype(np.float32), rs.randn(c).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jnorm.group_norm_act(*map(jnp.asarray, (x, g, bt)), groups=32, eps=1e-5, act=act,
                                   site="resnet")
    out = tnorm.group_norm(T(x), T(g), T(bt), groups=32, eps=1e-5, act=act)
    assert jax_calls == [1]
    assert tnorm.gn_route(t, c, 32, torch.bfloat16, "cuda", False, "resnet",
                          KernelChoices(gn_kernel_sites="all"),
                          smem_bytes=H100_SMEM) == "gn_kernel"
    assert rel_err(out.numpy(), ref) < 1e-5


@pytest.mark.parametrize("sites,site,t,c,taken,groups", [
    pytest.param("all", "midas", 64, 256, True, 4, id="all-midas-64-256-True"),
    pytest.param({"resnet"}, "resnet", 64, 320, True, 4, id="sites1-resnet-64-320-True"),
    # site not chosen
    pytest.param({"resnet"}, "attn_in", 64, 320, False, 4, id="sites2-attn_in-64-320-False"),
    # no site chosen ("none")
    pytest.param(frozenset(), "resnet", 64, 320, False, 4, id="sites3-resnet-64-320-False"),
    # T * C > 3 * 2^20, the JAX package's cap, which the CUDA kernel has not
    pytest.param("all", "resnet", 4096, 960, True, 4, id="all-resnet-4096-960-True"),
    pytest.param("all", "resnet", 16, 36, False, 4, id="all-resnet-16-36-False"),  # C % 8
    # wider than the UNet's 2560, any G dividing C: the kernel
    pytest.param("all", "resnet", 64, 4096, True, 32, id="all-resnet-64-4096-True-32"),
    pytest.param("all", "resnet", 64, 4096, True, 512, id="all-resnet-64-4096-True-512"),
    # wider than the kernel's row (GN_MAX_CHANNELS): the plain version
    pytest.param("all", "resnet", 64, 16392, False, 8, id="all-resnet-64-16392-False-8"),
])
def test_group_norm_site_dispatch(monkeypatch, sites, site, t, c, taken, groups):
    """A bf16 card call takes the kernel where C meets the JAX package's
    conditions on it (norm.py:140-147), the kernel has a plan for a row of C
    and the pipeline names the site; this fp32 CPU call runs the plain
    version whatever the site."""
    calls = []
    real = tnorm.group_norm
    monkeypatch.setattr(tnorm, "group_norm",
                        lambda *a, **kw: (calls.append(1), real(*a, **kw))[1])
    rs = np.random.RandomState(17)
    x = T(rs.randn(1, t, c).astype(np.float32))
    kernels = KernelChoices(gn_kernel_sites=sites)
    out = tnorm.group_norm_act(x, torch.ones(c), torch.zeros(c), groups=groups, act="silu",
                               site=site, kernels=kernels)
    on_card = tnorm.gn_route(t, c, groups, BF16, "cuda", False, site, kernels,
                             smem_bytes=H100_SMEM)
    assert on_card == ("gn_kernel" if taken else "gn_plain") and calls == []
    torch.testing.assert_close(out, tnorm.group_norm_plain(x, torch.ones(c), torch.zeros(c),
                                                           groups, 1e-5, "silu"))


@pytest.mark.parametrize("t,c,groups,jax_takes", [
    (64, 320, 32, True),
    (64, 4096, 32, True),      # wider than any model's GroupNorm
    (64, 4096, 512, True),     # more than 256 groups
    (64, 64, 16, True),        # C / G = 4 < 8: a vector spans groups
    (64, 16392, 8, True),      # C > GN_MAX_CHANNELS: JAX's kernel, the port's plain version
    (4096, 960, 32, False),    # T * C > 3 * 2^20: JAX's plain version, the port's kernel
    (16, 36, 4, False),        # C % 8 != 0
])
def test_group_norm_gate_matches_jax(monkeypatch, t, c, groups, jax_takes):
    """The port's route sends a bf16 card call to its kernel wherever the
    JAX package sends it to the Pallas kernel (norm.py:140-147, run in
    interpret mode) and the row fits the kernel, and also past the JAX
    package's cap on T * C, which held a whole sample in VMEM (the CUDA
    kernel streams its tiles); where the routes differ the result (here the
    CPU's plain version) does not."""
    monkeypatch.setattr(jnorm, "_GN_SITE_TAGS", set())
    monkeypatch.setattr(jattn, "_BACKEND", "tpu")
    jax_calls = []
    real_j = jnorm._group_norm_kernel
    monkeypatch.setattr(jnorm, "_group_norm_kernel",
                        lambda *a, **kw: (jax_calls.append(1), real_j(*a, **kw))[1])
    rs = np.random.RandomState(19)
    x = (rs.randn(1, t, c) * 3 + 1).astype(np.float32)
    g, bt = (1 + 0.1 * rs.randn(c)).astype(np.float32), (0.1 * rs.randn(c)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jnorm.group_norm_act(*map(jnp.asarray, (x, g, bt)), groups=groups, eps=1e-5,
                                   act="silu", site="resnet")
    kernels = KernelChoices(gn_kernel_sites="all")
    out = tnorm.group_norm_act(T(x), T(g), T(bt), groups=groups, eps=1e-5, act="silu",
                               site="resnet", kernels=kernels)
    on_card = tnorm.gn_route(t, c, groups, BF16, "cuda", False, "resnet", kernels,
                             smem_bytes=H100_SMEM)
    assert len(jax_calls) == int(jax_takes)
    assert (on_card == "gn_kernel") == (c % 8 == 0 and c <= tnorm.GN_MAX_CHANNELS)
    assert rel_err(out.numpy(), ref) < 1e-5


H100_SMS, H100_SMEM = 132, 232448  # SMs, shared memory a block may opt into
# the GroupNorm calls of a 512x512 stream step at gn_kernel_sites="all"
# ([B, T, C]): the UNet's at B = 2 denoising steps, the DPT's at B = 1
GN_STEP_SHAPES = [
    (2, 4096, 320), (2, 4096, 640), (2, 1024, 320), (2, 1024, 640), (2, 1024, 960),
    (2, 1024, 1280), (2, 1024, 1920), (2, 256, 640), (2, 256, 1280), (2, 256, 1920),
    (2, 256, 2560), (2, 64, 1280), (2, 64, 2560), (1, 576, 256), (1, 576, 1024),
    (1, 2304, 128), (1, 2304, 256), (1, 2304, 512), (1, 9216, 64), (1, 9216, 128),
    (1, 9216, 256), (1, 36864, 64),
]


@pytest.mark.parametrize("b,t,c,groups", [
    *[(*shape, 32) for shape in GN_STEP_SHAPES],
    # prepare: the UNet over the 8 warmup frames folded into B, the DPT over them
    (8, 4096, 320, 32), (8, 4096, 640, 32), (8, 1024, 1920, 32), (8, 256, 2560, 32),
    (8, 576, 256, 32), (8, 9216, 256, 32), (8, 36864, 64, 32),
    # the UNet's calls past the JAX cap at 512x512, 768x512 and 4 sessions
    (2, 4096, 960, 32), (2, 6144, 960, 32), (2, 6144, 640, 32), (8, 4096, 960, 32),
    *[(*shape, 32) for shape in GN_CODEC_SHAPES],
    (1, 1, 8, 1), (1, 4097, 320, 32), (3, 333, 1280, 32), (16, 64, 320, 32),
    (1, 64, 4096, 512), (1000, 64, 320, 32), (1, 8, 16384, 16384),
])
def test_group_norm_plan(b, t, c, groups):
    """The kernel's plan on an H100: every row of every sample in exactly one
    tile, no tile across two samples, runs of tiles per CTA, at most one CTA
    an SM, the buffers within shared memory, few CTAs for small slabs, and
    every stream-step call of the UNet and the DPT resident (x read once)."""
    plan = tnorm.group_norm_plan(b, t, c, groups, H100_SMS, H100_SMEM)
    tiles = list(plan.tiles(b, t))
    assert len(tiles) == b * plan.tiles_per_sample
    for s in range(b):
        spans = [(r0, r1) for _, ts, r0, r1 in tiles if ts == s]
        assert spans[0][0] == 0 and spans[-1][1] == t
        assert all(r0 < r1 and r1 == nxt for (r0, r1), (nxt, _) in zip(spans, spans[1:] + [(t, 0)]))
    assert max(r1 - r0 for _, _, r0, r1 in tiles) == plan.rows
    ctas = [cta for cta, _, _, _ in tiles]
    assert ctas == sorted(ctas) and set(ctas) == set(range(plan.ctas))
    assert max(Counter(ctas).values()) == plan.tiles_per_cta
    assert plan.ctas <= H100_SMS
    assert plan.smem_bytes <= H100_SMEM and 1 <= plan.slots <= plan.tiles_per_cta
    slab = b * t * 2 * c
    assert plan.ctas <= max(1, slab // tnorm.GN_MIN_TILE_BYTES)
    assert plan.ctas >= min(H100_SMS, slab // tnorm.GN_MIN_TILE_BYTES, b * t) // 2
    if (b, t, c) in GN_STEP_SHAPES:
        assert plan.resident and plan.tiles_per_cta == 1
    if plan.tiles_per_cta > 1 and plan.rows > 1:
        assert plan.slots >= 2  # the next tile's copy in flight while one is reduced
    if (b, t, c) == (1, 576, 256):
        assert plan.ctas <= 18


def test_kernel_choices_validate():
    assert KernelChoices().gn_kernel_sites == "all"
    assert KernelChoices().ln_kernel_at("vit") and KernelChoices().ln_kernel_at("spatial")
    assert KernelChoices(gn_kernel_sites="all").gn_kernel_at("midas")
    assert not KernelChoices(ln_kernel_sites="none").ln_kernel_at("vit")
    with pytest.raises(ValueError):
        KernelChoices(flash_variant="fp8")
    with pytest.raises(ValueError):
        KernelChoices(gn_kernel_sites={"resnt"})
    with pytest.raises(TypeError):
        KernelChoices(gn_kernel_sites="resnet")


ALL, NONE = KernelChoices(), KernelChoices(gn_kernel_sites="none", ln_kernel_sites="none")
BF16, F32 = torch.bfloat16, torch.float32
# the LayerNorm calls of a 512x512 stream step ([..., C] as (elements, C)):
# the UNet's spatial and temporal sites at each latent level, the DPT's ViT
LN_STEP_SHAPES = [(2 * 4096 * 320, 320), (2 * 1024 * 640, 640), (2 * 256 * 1280, 1280),
                  (2 * 64 * 1280, 1280), (577 * 768, 768)]


def _gn_case(t, c, dtype=BF16, device="cuda", grad=False, site="resnet", kernels=ALL,
             kernel=True, groups=32):
    return ("gn", (t, c, groups), dtype, device, grad, site, kernels, kernel)


def _ln_case(numel, c, dtype=BF16, device="cuda", grad=False, site="spatial", kernels=ALL,
             kernel=True):
    return ("ln", (numel, c), dtype, device, grad, site, kernels, kernel)


@pytest.mark.parametrize("norm,shape,dtype,device,grad,site,kernels,kernel", [
    # a bf16 card call with no gradient takes the kernel at every site by default
    *[pytest.param(*_gn_case(4096, 320, site=s), id=f"gn-{s}") for s in sorted(
        ["resnet", "attn_in", "motion_in", "midas", "vae"])],
    *[pytest.param(*_ln_case(2 * 4096 * 320, 320, site=s), id=f"ln-{s}") for s in sorted(
        ["spatial", "temporal", "vit"])],
    # and at every shape of a 512x512 stream step that the kernels take
    *[pytest.param(*_gn_case(t, c), id=f"gn-step-{b}x{t}x{c}") for b, t, c in GN_STEP_SHAPES],
    *[pytest.param(*_ln_case(n, c), id=f"ln-step-{n}x{c}") for n, c in LN_STEP_SHAPES],
    # the UNet's top up-block input, past the JAX package's cap on T * C
    # (its kernel held a whole sample in VMEM): the CUDA kernel has a plan
    pytest.param(*_gn_case(4096, 960), id="gn-step-past-jax-cap-planned"),
    # prepare's 8 warmup frames in one slab: past that cap, streamed
    pytest.param(*_gn_case(8 * 4096, 320), id="gn-8-frame-slab-streamed"),
    # and the KL codec's, to 512x512 at 128 and 256 channels
    *[pytest.param(*_gn_case(t, c, site="vae"), id=f"gn-codec-{b}x{t}x{c}")
      for b, t, c in GN_CODEC_SHAPES],
    # fp32 pipelines, fp16, training with a gradient, the CPU, "none" chosen
    pytest.param(*_gn_case(4096, 320, dtype=F32, kernel=False), id="gn-fp32"),
    pytest.param(*_ln_case(2 * 4096 * 320, 320, dtype=F32, kernel=False), id="ln-fp32"),
    pytest.param(*_gn_case(4096, 320, dtype=torch.float16, kernel=False), id="gn-fp16"),
    pytest.param(*_gn_case(4096, 320, grad=True, kernel=False), id="gn-grad"),
    pytest.param(*_ln_case(2 * 4096 * 320, 320, grad=True, kernel=False), id="ln-grad"),
    pytest.param(*_gn_case(4096, 320, device="cpu", kernel=False), id="gn-cpu"),
    pytest.param(*_ln_case(2 * 4096 * 320, 320, device="cpu", kernel=False), id="ln-cpu"),
    pytest.param(*_gn_case(4096, 320, kernels=NONE, kernel=False), id="gn-none"),
    pytest.param(*_ln_case(577 * 768, 768, site="vit", kernels=NONE, kernel=False),
                 id="ln-none"),
    # the LayerNorm's shape conditions: too few elements, C % 8, too wide
    pytest.param(*_ln_case(2 * 64 * 64, 64, kernel=False), id="ln-small"),
    pytest.param(*_ln_case(256 * 68, 68, kernel=False), id="ln-c-not-8"),
    pytest.param(*_ln_case(4 * 10248, 10248, kernel=False), id="ln-too-wide"),
])
def test_norm_route(norm, shape, dtype, device, grad, site, kernels, kernel):
    """``gn_route`` and ``ln_route``: the kernel for a bf16 CUDA call with
    no gradient through it, at a chosen site, where the shape conditions
    hold; the plain version for every other call. GroupNorm on an H100's
    shared memory, which a card call reads from its card."""
    if norm == "gn":
        route = tnorm.gn_route(*shape, dtype, device, grad, site, kernels,
                               smem_bytes=H100_SMEM)
    else:
        route = tnorm.ln_route(*shape, dtype, device, grad, site, kernels)
    assert route == f"{norm}_{'kernel' if kernel else 'plain'}"


@pytest.mark.parametrize("c,groups,smem,kernel", [
    (16384, 32, H100_SMEM, True),  # the widest row GN_MAX_CHANNELS allows fits an H100
    (16384, 32, 48 * 1024, False),  # no row fits 48 KB beside gamma, beta, work area
    (4096, 32, 48 * 1024, True),  # one row of 4096 does
    (128, 32, H100_SMEM, True),  # the KL codec's narrowest GroupNorm
])
def test_gn_route_takes_the_kernels_plan(c, groups, smem, kernel):
    """A bf16 card call takes the kernel only where ``group_norm_plan`` finds
    a plan (a row of C fits a CTA's shared memory), whatever T."""
    for t in (1, 4096, 262144):
        route = tnorm.gn_route(t, c, groups, BF16, "cuda", False, "vae", ALL, smem_bytes=smem)
        assert route == ("gn_kernel" if kernel else "gn_plain")
    if not kernel:
        with pytest.raises(ValueError):
            tnorm.group_norm_plan(1, 64, c, groups, H100_SMS, smem)
    if kernel:
        assert tnorm.group_norm_plan(1, 262144, c, groups, H100_SMS, smem).ctas >= 1
    assert tnorm.gn_route(0, c, groups, BF16, "cuda", False, "vae", ALL,
                          smem_bytes=smem) == "gn_plain"  # no rows: no plan


def test_norm_calls_count_their_route_and_keep_the_gradient():
    """A CPU call counts a plain route; a call that needs a gradient (the
    trainer's) is plain and differentiable; under no_grad none is needed."""
    rs = np.random.RandomState(20)
    x = T(rs.randn(2, 64, 32).astype(np.float32)).requires_grad_(True)
    g, b = torch.ones(32, requires_grad=True), torch.zeros(32)
    before = dict(tnorm.norm_route_counts)
    y = tnorm.group_norm_act(x, g, b, groups=4, act="silu", site="resnet")
    z = tnorm.layer_norm(y, g, b, site="spatial")
    z.square().sum().backward()
    assert x.grad is not None and g.grad is not None and torch.isfinite(x.grad).all()
    after = tnorm.norm_route_counts
    assert {k: after[k] - before[k] for k in after} == {
        "gn_kernel": 0, "gn_plain": 1, "ln_kernel": 0, "ln_plain": 1}
    assert _build.needs_grad(x, b) and not _build.needs_grad(b, None)
    with torch.no_grad():
        assert not _build.needs_grad(x, g)
