"""Stream window attention over the int8 KV cache: kernel wrapper and plain version.

The hot per-frame op of the motion modules: each (step, spatial position,
head) attends over its own 16-slot temporal window of the cache. The CUDA
kernel (``csrc/stream_attention.cu``) replaces the Pallas TPU kernel
``live2diff_tpu/ops/stream_attention.py:stream_window_attention_kernel_int8``;
``stream_window_attention_plain`` computes the same function in plain
torch, as the JAX package's non-TPU path does (``ops/attention.py:220-243``).

Math, with the positional encodings factored out of the cache:

    logits = scale * q_full . (k8 * k_scale)  +  extra
    probs  = softmax over the window (fp32)
    out    = probs . (v8 * v_scale + pe_v)

``extra`` = scale * q_full . pe_k + visibility bias, computed by the caller.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NAME = "stream_attention_int8"


def stream_window_attention_plain(
    q_full: torch.Tensor,  # [s, HW, C]
    cache_data: torch.Tensor,  # [s, 2, window, C, HW] int8 or float
    scales: Optional[torch.Tensor],  # [s, 2, window, C] f32, None for a float cache
    extra: torch.Tensor,  # [s, window, heads, HW] f32
    pe_v: torch.Tensor,  # [s, window, C]
    scale: float,
    heads: int,
) -> torch.Tensor:
    """Plain torch version of the kernel: the dequantised cache in q's dtype,
    products with fp32 accumulation, probabilities cast to q's dtype before
    the value product. Runs wherever its tensors lie; with TF32 off it is
    the kernel's reference on the card. Returns [s, HW, C] in q's dtype."""
    s, hw, c = q_full.shape
    window = cache_data.shape[2]
    dh = c // heads
    dt = q_full.dtype
    if scales is not None:
        dq = cache_data.float() * scales.float()[..., None]
        kch, vch = dq[:, 0].to(dt), dq[:, 1].to(dt)
    else:
        kch, vch = cache_data[:, 0].to(dt), cache_data[:, 1].to(dt)
    kch = kch.reshape(s, window, heads, dh, hw).float()
    vch = vch.reshape(s, window, heads, dh, hw).float()
    qh = q_full.reshape(s, hw, heads, dh).float()
    logits = torch.einsum("sphd,swhdp->swhp", qh, kch) * scale + extra.float()
    probs = torch.softmax(logits, dim=1).to(dt).float()
    pvh = pe_v.to(dt).reshape(s, window, heads, dh).float()
    out = torch.einsum("swhp,swhdp->sphd", probs, vch)
    out = out + torch.einsum("swhp,swhd->sphd", probs, pvh)
    return out.to(dt).reshape(s, hw, c)


def stream_window_attention_int8(
    q_full: torch.Tensor,  # [s, HW, C] bf16
    cache_data: torch.Tensor,  # [s, 2, 16, C, HW] int8
    scales: torch.Tensor,  # [s, 2, 16, C] f32
    extra: torch.Tensor,  # [s, 16, heads, HW] f32
    pe_v: torch.Tensor,  # [s, 16, C] f32
    scale: float,
    heads: int,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; a CPU tensor runs the plain
    version. Returns [s, HW, C] in q's dtype."""
    if not q_full.is_cuda:
        return stream_window_attention_plain(
            q_full, cache_data, scales, extra, pe_v, scale, heads
        )
    s, hw, c = q_full.shape
    window = cache_data.shape[2]
    _build.require(q_full, "q_full", torch.bfloat16, 3)
    _build.require(cache_data, "cache_data", torch.int8, 5)
    _build.require(scales, "scales", torch.float32, 4)
    _build.require(extra, "extra", torch.float32, 4)
    _build.require(pe_v, "pe_v", torch.float32, 3)
    if (
        tuple(cache_data.shape) != (s, 2, window, c, hw)
        or tuple(scales.shape) != (s, 2, window, c)
        or tuple(extra.shape) != (s, window, heads, hw)
        or tuple(pe_v.shape) != (s, window, c)
        or window != 16
        or c % heads
    ):
        raise ValueError(
            f"stream_window_attention_int8: unsupported shapes q {tuple(q_full.shape)}, "
            f"cache {tuple(cache_data.shape)}, scales {tuple(scales.shape)}, "
            f"extra {tuple(extra.shape)}, pe_v {tuple(pe_v.shape)}, heads {heads}"
        )
    out = torch.empty_like(q_full)
    lib = _build.load("stream_attention")
    fn = lib.stream_attention_int8
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(
        q_full.data_ptr(), cache_data.data_ptr(), scales.data_ptr(), extra.data_ptr(),
        pe_v.data_ptr(), out.data_ptr(), s, window, c, hw, heads, float(scale),
        _build.stream_handle(q_full),
    )
    _build.check(rc, NAME)
    _build.launch_counts[NAME] += 1
    return out
