"""Attention entry points of the model code, in the ``[..., S, H, D]`` layout.

Port of ``live2diff_tpu/ops/attention.py``. Two functions:

* ``dot_product_attention``: scaled dot-product attention. On CUDA tensors
  every call without a bias launches the flash kernel (any rank: leading
  dims fold into the batch); a call with a bias has no kernel yet and
  raises there. On the CPU it runs the plain dense version.
* ``stream_window_attention``: one new frame's temporal attention over the
  streaming KV cache, with the positional encodings factored out of the
  cache. An int8 cache goes through the int8 stream-attention kernel on
  CUDA; a float cache runs the plain version on the CPU and raises on CUDA
  until its kernel is ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..stream.state import KVCache
from .flash_attention import flash_attention, flash_attention_plain
from .stream_attention import stream_window_attention_int8, stream_window_attention_plain


def dot_product_attention(
    q: torch.Tensor,  # [..., Sq, H, D]
    k: torch.Tensor,  # [..., Sk, H, D]
    v: torch.Tensor,  # [..., Sk, H, D]
    bias: Optional[torch.Tensor] = None,  # broadcastable to [..., H, Sq, Sk]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Scaled dot-product attention; returns ``[..., Sq, H, D]`` in q's
    dtype with the softmax in fp32. ``scale`` defaults to ``D**-0.5``."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    lead = q.shape[:-3]
    q4 = q.reshape(-1, *q.shape[-3:])
    k4 = k.reshape(-1, *k.shape[-3:])
    v4 = v.reshape(-1, *v.shape[-3:])
    if q.is_cuda:
        if bias is not None:
            raise NotImplementedError(
                "dot_product_attention with a bias has no CUDA kernel yet "
                "(its only user, the text encoder, is not ported)"
            )
        out = flash_attention(q4.contiguous(), k4.contiguous(), v4.contiguous(), scale)
    else:
        if bias is not None:
            bias = bias.expand(*lead, q.shape[-2], q.shape[-3], k.shape[-3])
            bias = bias.reshape(-1, *bias.shape[-3:])
        out = flash_attention_plain(q4, k4, v4, scale, bias)
    return out.reshape(*lead, *out.shape[-3:]).to(q.dtype)


def stream_window_attention(
    q: torch.Tensor,  # [steps, HW, C] the frame's queries (PE-free)
    kv_cache: KVCache,  # [steps, 2, window, C, HW] (new K/V already written)
    pe_q: torch.Tensor,  # [steps, C] the query slot's PE row
    pe_k: torch.Tensor,  # [steps, window, C] gathered K PE rows
    pe_v: torch.Tensor,  # [steps, window, C] gathered V PE rows
    bias: torch.Tensor,  # [steps, window] additive visibility bias
    heads: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Windowed temporal attention of one new frame over the cache.

    Adding the gathered PE rows onto the cached K/V would materialise two
    PE-shifted copies of the cache each frame. The PE terms are factored
    out instead (an exact expansion):

        logits = q_full . k_cache + q_full . pe_k
        out    = p . v_cache      + p . pe_v

    so the cache is read once, PE-free. Returns ``[steps, HW, C]`` in q's
    dtype.
    """
    s, hw, c = q.shape
    quantized = isinstance(kv_cache, tuple)
    cache_data = kv_cache[0] if quantized else kv_cache
    window = cache_data.shape[2]
    dh = c // heads
    scale = dh**-0.5 if scale is None else scale
    dt = q.dtype

    q_full = (q + pe_q[:, None, :]).to(dt)
    qh = q_full.reshape(s, hw, heads, dh).float()
    pkh = pe_k.to(dt).reshape(s, window, heads, dh).float()
    # PE logits and the bias, [steps, window, heads, HW] fp32 (a few MB)
    extra = torch.einsum("sphd,swhd->swhp", qh, pkh) * scale
    extra = extra + bias.float()[:, :, None, None]
    if quantized:
        return stream_window_attention_int8(
            q_full.contiguous(), cache_data, kv_cache[1], extra.contiguous(),
            pe_v.float().contiguous(), scale, heads,
        )
    if q.is_cuda:
        raise NotImplementedError(
            "stream attention over a float KV cache has no CUDA kernel yet; "
            "use kv_cache_dtype='int8'"
        )
    return stream_window_attention_plain(q_full, cache_data, None, extra, pe_v, scale, heads)
