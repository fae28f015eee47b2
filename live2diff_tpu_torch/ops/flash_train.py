"""Flash attention for training: fp32 kernels with a backward, and their plain versions.

``csrc/flash_train.cu`` holds the counterpart, at fp32 and with a
gradient, of the Pallas TPU kernel ``live2diff_tpu/ops/flash_attention.py:
flash_self_attention_dmajor``: ``softmax(scale q k^T) v`` with no mask and
no bias. The TPU kernel has no backward (JAX cannot take a reverse-mode
gradient through a ``pallas_call``); here the forward also writes the row
log-sum-exp, and the backward recomputes the probabilities from it
(``P = exp(scale q k^T - lse)``), as flash attention does.

Each wrapper has two routes, which ``train_route`` picks from the lengths:

* ``"short"`` (Sq and Sk at most ``SHORT_MAX``: the clip-mode temporal
  attention at S = 4, the 4 x 4 latent's self-attention at S = 16) is bound
  by bytes. A CTA owns whole ``[S, H, D]`` slabs of consecutive samples
  (or a run of heads of one), copied into shared memory with 16-byte
  ``cp.async``, 8 lanes a row; the forward is one launch, and so is the
  backward (delta, P, dS and dQ a query row, then dK and dV a key row).
* ``"tiled"`` (everything else) is bound by its products, which run on the
  tensor cores in 3xTF32 (``mma.sync`` m16n8k8: each operand split into a
  TF32 big part and a TF32 remainder, three products summed in fp32), which
  keeps fp32's accuracy, as PyTorch's fp32 attention does; 64-row tiles,
  the other sequence's tiles double-buffered through ``cp.async`` (at D >
  80 with at most 128 keys the forward's CTA owns 16 rows and its warps
  split the keys instead). The backward launches two kernels: dQ with the
  row sums ``delta = rowsum(dO * O)``, then dK and dV.

Neither route uses atomics, so a run repeats bit for bit.

* ``flash_train_fwd`` -> (O, lse), ``flash_train_bwd`` -> (dq, dk, dv): one
  counted launch a call in ``_build.launch_counts``, and one in
  ``route_counts`` under ``"<wrapper>:<route>"``;
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
from typing import Dict, Tuple

import torch

from . import _build

FWD_NAME = "flash_train_fwd"
BWD_NAME = "flash_train_bwd"
MAX_HEAD_DIM = 160
# the short route's longest Sq and Sk (csrc/flash_train.cu SHORT_MAX): 8
# lanes a row and at most 256 threads a CTA, so whole rows of S = 4 (the
# clip-mode temporal attention) and S = 16 (the 4 x 4 latent) fit
SHORT_MAX = 16
ROUTES = ("short", "tiled")

# launches of each wrapper by route, counted where it launches
route_counts: Dict[str, int] = {f"{w}:{r}": 0 for w in (FWD_NAME, BWD_NAME) for r in ROUTES}


def train_route(sq: int, sk: int, d: int) -> str:
    """The route of a call with these lengths and head width: ``"short"``
    where both lengths are at most ``SHORT_MAX``, else ``"tiled"``. Every D
    up to ``MAX_HEAD_DIM`` takes either."""
    del d  # either route takes every width up to MAX_HEAD_DIM
    return "short" if sq <= SHORT_MAX and sk <= SHORT_MAX else "tiled"


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
    """The C entries by (wrapper, route), built and loaded at first use,
    argument types set once. The tiled backward also takes delta's scratch."""
    lib = _build.load("flash_train")
    tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    entries = {}
    for route in ROUTES:
        fwd = getattr(lib, f"flash_train_{route}_fwd")
        bwd = getattr(lib, f"flash_train_{route}_bwd")
        fwd.argtypes = [ctypes.c_void_p] * 5 + tail
        bwd.argtypes = [ctypes.c_void_p] * (10 if route == "tiled" else 9) + tail
        fwd.restype = bwd.restype = ctypes.c_int
        entries[FWD_NAME, route], entries[BWD_NAME, route] = fwd, bwd
    return entries


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
    sk = k.shape[1]
    route = train_route(sq, sk, d)
    out = torch.empty_like(q)
    lse = torch.empty((n, h, sq), dtype=torch.float32, device=q.device)
    rc = _launchers()[FWD_NAME, route](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), n, h, sq, sk,
        d, float(scale), _build.stream_handle(q))
    _build.check(rc, FWD_NAME)
    _build.launch_counts[FWD_NAME] += 1
    route_counts[f"{FWD_NAME}:{route}"] += 1
    return out, lse


def flash_train_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's inputs, its O and lse, and O's
    gradient ``do``. Launches the CUDA kernels on CUDA tensors (one counted
    launch a call: one kernel on the short route, two on the tiled); a CPU
    tensor runs the plain version."""
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
    sk = k.shape[1]
    route = train_route(sq, sk, d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr()]
    if route == "tiled":  # the dQ kernel writes delta for the dK/dV kernel
        delta = torch.empty_like(lse)
        ptrs.append(delta.data_ptr())
    rc = _launchers()[BWD_NAME, route](
        *ptrs, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), n, h, sq, sk, d, float(scale),
        _build.stream_handle(q))
    _build.check(rc, BWD_NAME)
    _build.launch_counts[BWD_NAME] += 1
    route_counts[f"{BWD_NAME}:{route}"] += 1
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
