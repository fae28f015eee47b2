"""Attention entry points of the model code, in the ``[..., S, H, D]`` layout.

Port of ``live2diff_tpu/ops/attention.py``. Two functions:

* ``dot_product_attention``: scaled dot-product attention, sent by
  ``attention_route`` to one of these:

  - ``dense``: a call with a bias (the text encoder's causal mask), on
    every device: fp32 logits plus the bias, then the softmax. No Pallas
    kernel computes that function; the JAX package sends it to plain XLA.
  - ``train``: on CUDA, a call that needs a gradient (grad mode on and q,
    k or v requiring grad) or whose inputs are fp32 goes through
    ``flash_train.FlashAttentionTrain``, the fp32 flash kernels with their
    backward (any rank: leading dims fold into the batch). A call that
    needs a gradient in another dtype raises: no kernel of the port would
    carry its gradient.
  - the caller's ``flash_variant``, for a call that passes the JAX
    package's flash gate (``live2diff_tpu/ops/attention.py:268-278``: no
    bias, rank 4, Sq == Sk >= 1024, both multiples of 128): ``smajor`` or
    ``int8`` take their own kernels there (their plain versions on the
    CPU).
  - ``dmajor``: every other call on CUDA, the d-major flash kernel (bf16,
    any rank).
  - ``plain``: every other call on the CPU, the plain dense version,
    which autograd differentiates.
* ``stream_window_attention``: one new frame's temporal attention over the
  streaming KV cache, with the positional encodings factored out of the
  cache. On CUDA an int8 cache goes through the int8 stream-attention
  kernel and a bf16 cache through its bf16 twin; any other cache dtype
  raises there. On the CPU it runs the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..stream.state import KVCache
from .choices import FLASH_VARIANTS
from .flash_attention import (
    flash_attention, flash_attention_plain, flash_self_attention, flash_self_attention_int8,
)
from .flash_train import FlashAttentionTrain
from .stream_attention import (
    stream_window_attention_bf16, stream_window_attention_int8, stream_window_attention_plain,
)

# sequence length from which the flash variants take over (the JAX gate)
FLASH_MIN_SEQ = 1024


def flash_gate(q: torch.Tensor, k: torch.Tensor, bias: Optional[torch.Tensor]) -> bool:
    """Whether a call takes the flash variant: the JAX package's gate."""
    sq, sk = q.shape[-3], k.shape[-3]
    return (bias is None and q.dim() == 4 and sq == sk and sk >= FLASH_MIN_SEQ
            and sq % 128 == 0 and sk % 128 == 0)


def attention_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor], flash_variant: str, cuda: bool) -> str:
    """Where ``dot_product_attention`` sends a call (see the module's note):
    ``dense``, ``train``, ``smajor``, ``int8``, ``dmajor`` or ``plain``.
    ``cuda``: whether the tensors lie on a CUDA device."""
    if flash_variant not in FLASH_VARIANTS:
        raise ValueError(f"flash_variant {flash_variant!r}: expected one of {FLASH_VARIANTS}")
    if bias is not None:
        return "dense"
    if cuda:
        needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
        if needs_grad and q.dtype != torch.float32:
            raise TypeError(
                f"attention on CUDA needs a gradient through {q.dtype} inputs; the training "
                "kernels take fp32 (train in fp32, or run under torch.no_grad())")
        if needs_grad or q.dtype == torch.float32:
            return "train"
    if flash_variant != "dmajor" and flash_gate(q, k, bias):
        return flash_variant
    return "dmajor" if cuda else "plain"


def dot_product_attention(
    q: torch.Tensor,  # [..., Sq, H, D]
    k: torch.Tensor,  # [..., Sk, H, D]
    v: torch.Tensor,  # [..., Sk, H, D]
    bias: Optional[torch.Tensor] = None,  # broadcastable to [..., H, Sq, Sk]
    scale: Optional[float] = None,
    flash_variant: str = "dmajor",
) -> torch.Tensor:
    """Scaled dot-product attention; returns ``[..., Sq, H, D]`` in q's
    dtype with the softmax in fp32. ``scale`` defaults to ``D**-0.5``.
    ``flash_variant`` (``dmajor``, ``smajor`` or ``int8``) picks the kernel
    of the calls that pass ``flash_gate``, with the JAX dispatch's blocks."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    route = attention_route(q, k, v, bias, flash_variant, q.is_cuda)
    if route in ("smajor", "int8"):
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # [B, H, S, D] views
        if route == "smajor":
            out = flash_self_attention(qt, kt, vt, scale, block_q=512, block_k=1024)
        else:
            out = flash_self_attention_int8(qt, kt, vt, scale, block_q=512,
                                            block_k=min(k.shape[-3], 4096))
        return out.transpose(1, 2).to(q.dtype)
    lead = q.shape[:-3]
    q4 = q.reshape(-1, *q.shape[-3:])
    k4 = k.reshape(-1, *k.shape[-3:])
    v4 = v.reshape(-1, *v.shape[-3:])
    if route == "dense":
        bias = bias.expand(*lead, q.shape[-2], q.shape[-3], k.shape[-3])
        out = flash_attention_plain(q4, k4, v4, scale, bias.reshape(-1, *bias.shape[-3:]))
    elif route == "train":
        out = FlashAttentionTrain.apply(q4.contiguous(), k4.contiguous(), v4.contiguous(), scale)
    elif route == "dmajor":
        out = flash_attention(q4.contiguous(), k4.contiguous(), v4.contiguous(), scale)
    else:
        out = flash_attention_plain(q4, k4, v4, scale)
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
    if not q.is_cuda:
        return stream_window_attention_plain(q_full, cache_data, None, extra, pe_v, scale, heads)
    if cache_data.dtype != torch.bfloat16:
        raise TypeError(
            f"stream attention on CUDA takes an int8 or bf16 KV cache, got {cache_data.dtype}; "
            "use kv_cache_dtype='int8' or 'bf16'"
        )
    return stream_window_attention_bf16(
        q_full.contiguous(), cache_data, extra.contiguous(), pe_v.float().contiguous(),
        scale, heads,
    )
