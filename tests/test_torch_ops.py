"""The port's ops against the JAX package's: attention, convs, LayerNorm,
int8 quantisation.

On the CPU each kernel wrapper runs its plain torch version; these tests
hold that version (and the op around it) against the JAX function on the
same numpy inputs, and against the JAX package's Pallas kernel run in
interpret mode, at small shapes. All in fp32, where the two frameworks
differ only in summation order: tolerances are a few fp32 ulps of the
accumulated sums (1e-5 relative, 1e-4 where the Pallas kernel reassociates
the head reduction through a mask matmul).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import live2diff_tpu.ops.attention as jattn
from _torch_parity import rel_err
from live2diff_tpu.models.motion import _quantize_kv as jax_quantize_kv
from live2diff_tpu.ops.conv import conv3x3_fused, conv3x3_s2_fused
from live2diff_tpu.ops.flash_attention import flash_self_attention_dmajor
from live2diff_tpu.ops.norm import _layer_norm_kernel
from live2diff_tpu.ops.norm import layer_norm as jax_layer_norm
from live2diff_tpu.ops.stream_attention import (
    stream_window_attention_kernel, stream_window_attention_kernel_int8,
)
from live2diff_tpu_torch.models.motion import _quantize_kv
from live2diff_tpu_torch.ops import attention as tattn
from live2diff_tpu_torch.ops.conv import conv3x3
from live2diff_tpu_torch.ops.norm import layer_norm
from live2diff_tpu_torch.ops.stream_attention import (
    stream_window_attention_bf16, stream_window_attention_int8,
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


def test_stream_attention_int8_plain_matches_pallas_interpret():
    """Kernel #1's plain version == the Pallas int8 kernel (interpret mode)."""
    rs = np.random.RandomState(2)
    q, (data, scales), pe_q, pe_k, pe_v, bias, heads = _stream_inputs(rs, hw=128, cache="int8")
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


def test_stream_attention_bf16_plain_matches_pallas_interpret():
    """Kernel #2's plain version == the Pallas bf16-cache kernel (interpret
    mode): an fp32 query over the same bf16 cache on both sides. 1e-4: the
    Pallas kernel reassociates the head reduction through a mask matmul."""
    rs = np.random.RandomState(9)
    q, kv, pe_q, pe_k, pe_v, bias, heads = _stream_inputs(rs, hw=128, cache="bf16")
    q_full, extra, scale = _kernel_args(q, pe_q, pe_k, bias, heads)
    jcache, tcache = _bf16_pair(kv)
    with pltpu.force_tpu_interpret_mode():
        ref = stream_window_attention_kernel(
            jnp.asarray(q_full.transpose(0, 2, 1)), jcache, jnp.asarray(extra),
            jnp.asarray(pe_v.transpose(0, 2, 1)), scale=scale, heads=heads,
        )
    out = stream_window_attention_bf16(T(q_full), tcache, T(extra), T(pe_v), scale, heads)
    assert rel_err(out.numpy(), np.asarray(ref).transpose(0, 2, 1)) < 1e-4


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
    """Kernels #3 and #4's plain version == the Pallas fused convs."""
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
