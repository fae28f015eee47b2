"""Flash scaled-dot-product attention: kernel wrapper and plain version.

The CUDA kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``live2diff_tpu/ops/flash_attention.py:flash_self_attention_dmajor``: an
unmasked SDPA with an online softmax in fp32 and bf16 operands. It reads
the model's ``[B, S, H, D]`` layout in place and takes any Sq and Sk, so
every bias-free attention of the UNet runs through it on the card.
``flash_attention_plain`` is the same function in plain torch (the JAX
package's dense path, ``ops/attention.py:46-55``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NAME = "flash_attention"


def flash_attention_plain(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, H, D]
    v: torch.Tensor,  # [B, Sk, H, D]
    scale: float,
    bias: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Sq, Sk]
) -> torch.Tensor:
    """Dense attention: fp32 logits and softmax, probabilities cast to v's
    dtype, fp32 accumulation of the value product. Returns q's layout in
    v's dtype."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(v.dtype)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """softmax(scale q k^T) v over ``[B, S, H, D]`` tensors. Launches the CUDA
    kernel on CUDA tensors (bf16, contiguous, D % 8 == 0, D <= 160); a CPU
    tensor runs the plain version."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, scale)
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _build.require(t, what, torch.bfloat16, 4)
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {what} is not 16-byte aligned")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if (
        tuple(k.shape) != (b, sk, h, d) or tuple(v.shape) != (b, sk, h, d)
        or d % 8 or d > 160 or (d + 15) // 16 in (7, 9) or b > 65535 or h > 65535
    ):
        raise ValueError(
            f"flash_attention: unsupported shapes q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    fn = lib.flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, sq, sk, d, float(scale), _build.stream_handle(q),
    )
    _build.check(rc, NAME)
    _build.launch_counts[NAME] += 1
    return out
