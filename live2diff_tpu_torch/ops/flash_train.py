"""Flash attention for training: fp32 kernels with a backward, and their plain versions.

``csrc/flash_train.cu`` holds the counterpart, at fp32 and with a
gradient, of the Pallas TPU kernel ``live2diff_tpu/ops/flash_attention.py:
flash_self_attention_dmajor``: ``softmax(scale q k^T) v`` with no mask and
no bias. The TPU kernel has no backward (JAX cannot take a reverse-mode
gradient through a ``pallas_call``); here the forward also writes the row
log-sum-exp, and the backward recomputes the probabilities from it
(``P = exp(scale q k^T - lse)``), as flash attention does.

* ``flash_train_fwd`` -> (O, lse): one launch;
* ``flash_train_bwd`` -> (dq, dk, dv): three launches in one call (the row
  sums ``delta = rowsum(dO * O)``, then dK and dV, then dQ), no atomics,
  so a run repeats bit for bit;
* ``FlashAttentionTrain``, the ``torch.autograd.Function`` over the pair,
  which ``ops/attention.py:dot_product_attention`` calls on CUDA for every
  call that needs a gradient or whose inputs are fp32.

Tensors are in the model's ``[N, S, H, D]`` layout (q ``[N, Sq, H, D]``, k
and v ``[N, Sk, H, D]``), lse ``[N, H, Sq]``; fp32, contiguous, D <= 160.
``flash_train_fwd_plain`` and ``flash_train_bwd_plain`` are the same
functions in plain torch; a CPU tensor takes them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build

FWD_NAME = "flash_train_fwd"
BWD_NAME = "flash_train_bwd"
MAX_HEAD_DIM = 160


def flash_train_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense attention in fp32: returns (O ``[N, Sq, H, D]`` in q's dtype,
    lse ``[N, H, Sq]`` fp32), lse being the natural log-sum-exp of each
    row of ``scale q k^T``."""
    logits = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    out = torch.einsum("nhqk,nkhd->nqhd", p, v.float())
    return out.to(q.dtype), lse


def flash_train_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_train_fwd_plain``'s O with respect to q, k
    and v, given O's gradient ``do``, as the kernels compute it: P from
    lse, ``delta = rowsum(do * o)``, ``dS = P * (do v^T - delta)``."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(torch.einsum("nqhd,nkhd->nhqk", qf, kf) * scale - lse.float()[..., None])
    delta = (dof * o.float()).sum(-1).transpose(1, 2)  # [N, H, Sq]
    dv = torch.einsum("nhqk,nqhd->nkhd", p, dof)
    ds = p * (torch.einsum("nqhd,nkhd->nhqk", dof, vf) - delta[..., None])
    dq = torch.einsum("nhqk,nkhd->nqhd", ds, kf) * scale
    dk = torch.einsum("nhqk,nqhd->nkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.require(t, name, torch.float32, 4)
    n, sq, h, d = q.shape
    sk = k.shape[1]
    if (tuple(k.shape) != (n, sk, h, d) or tuple(v.shape) != (n, sk, h, d)
            or d > MAX_HEAD_DIM or 0 in q.shape or sk == 0):
        raise ValueError(
            f"{what}: unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} (D <= {MAX_HEAD_DIM})")


@functools.cache
def _launchers():
    """The two C entries, built and loaded at first use, argument types set once."""
    lib = _build.load("flash_train")
    fwd, bwd = lib.flash_train_fwd, lib.flash_train_bwd
    fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def flash_train_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, lse) of ``softmax(scale q k^T) v``. Launches the CUDA kernel on
    CUDA tensors; a CPU tensor runs the plain version."""
    if not q.is_cuda:
        return flash_train_fwd_plain(q, k, v, scale)
    _build.no_grad_through(FWD_NAME, q, k, v)
    _check(FWD_NAME, q, k, v)
    n, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((n, h, sq), dtype=torch.float32, device=q.device)
    rc = _launchers()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         lse.data_ptr(), n, h, sq, k.shape[1], d, float(scale),
                         _build.stream_handle(q))
    _build.check(rc, FWD_NAME)
    _build.launch_counts[FWD_NAME] += 1
    return out, lse


def flash_train_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's inputs, its O and lse, and O's
    gradient ``do``. Launches the CUDA kernels on CUDA tensors (one counted
    launch a call); a CPU tensor runs the plain version."""
    if not q.is_cuda:
        return flash_train_bwd_plain(q, k, v, o, lse, do, scale)
    _build.no_grad_through(BWD_NAME, q, k, v, o, lse, do)
    _check(BWD_NAME, q, k, v)
    n, sq, h, d = q.shape
    _build.require(o, "o", torch.float32, 4)
    _build.require(do, "do", torch.float32, 4)
    _build.require(lse, "lse", torch.float32, 3)
    if o.shape != q.shape or do.shape != q.shape or tuple(lse.shape) != (n, h, sq):
        raise ValueError(f"{BWD_NAME}: o {tuple(o.shape)}, do {tuple(do.shape)}, "
                         f"lse {tuple(lse.shape)} for q {tuple(q.shape)}")
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rc = _launchers()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                         lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                         dk.data_ptr(), dv.data_ptr(), n, h, sq, k.shape[1], d, float(scale),
                         _build.stream_handle(q))
    _build.check(rc, BWD_NAME)
    _build.launch_counts[BWD_NAME] += 1
    return dq, dk, dv


class FlashAttentionTrain(torch.autograd.Function):
    """``softmax(scale q k^T) v`` over ``[N, S, H, D]`` with the flash
    backward: the forward saves q, k, v, O and lse (``[N, H, Sq]``, a row
    of D floats' worth less than the probabilities), the backward launches
    ``flash_train_bwd``. On CPU tensors both run their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        out, lse = flash_train_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_train_bwd(q, k, v, out, lse, do.contiguous(), ctx.scale)
        return dq, dk, dv, None
