"""Tensor parallelism: the sharding rules, the collectives and ``shard_params``.

Port of the tp half of ``live2diff_tpu/parallel/mesh.py`` (``_TP_RULES``
:58-69, ``param_sharding_spec`` :72-87, ``shard_params`` :94-110). GSPMD
inserts the JAX package's collectives; here they are written out,
Megatron-style:

* a column-parallel projection (``to_q``, ``to_k``, ``to_v``,
  ``ff.net.0.proj``) takes the replicated input and gives this rank's slab
  of its output: the rank's heads, or its share of the feed-forward width;
* a row-parallel projection (``to_out.0``, ``ff.net.2``) takes that slab and
  gives a partial sum, which one ``all_reduce`` over the tp group
  completes; its bias is added once, after the reduce.

Resnet blocks: ``conv1`` and ``time_emb_proj`` are column-parallel (output
channels), ``norm2`` normalises this rank's channels (its groups split
evenly: 32 over tp in {2, 4, 8}) and ``conv2`` is row-parallel (input
channels), so a resnet block also costs one ``all_reduce``. The JAX package
shards ``conv2`` on its output channels instead and lets GSPMD gather; the
result is the same. The resamplers, ``conv_in``/``conv_out``, the
transformers' ``proj_in``/``proj_out``, the norms outside a resnet's
middle, the time embedding and the depth branch stay replicated.

Where tp does not divide a dim the JAX package replicates that leaf alone
(``mesh.py:78-84``), which GSPMD keeps correct. With explicit collectives a
column layer replicated beside a sharded row partner would sum a wrong
result, so the decision is made per block (one attention, one
feed-forward, one resnet block): all of it is sharded, or none of it.

The collectives are ``all_reduce`` only (the checkpoints' gathers too):
gloo takes them on CUDA tensors as on CPU ones, so two ranks can share one
card; NCCL runs them across cards through the same helpers. A step with
these collectives in it runs eagerly: a CUDA graph cannot capture gloo.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..convert.checkpoint import channels_last_convs_

COLUMN, ROW, GEGLU = "column", "row", "geglu"

# Matched against a parameter's name inside its block (a CrossAttention or
# TemporalAttention, a GEGLUFeedForward, a ResnetBlock3D: in the UNet's
# keys ``...attn1.to_q.weight``, ``...ff.net.0.proj.weight``,
# ``...resnets.0.conv1.weight``); first match wins. COLUMN shards dim 0 (a
# linear's or conv's output, and a column layer's bias), ROW dim 1 (the
# input; its bias stays whole), GEGLU dim 0 of both halves of the
# [hidden | gate] projection.
_TP_RULES: Sequence[Tuple[str, str]] = (
    (r"^(to_q|to_k|to_v)\.weight$", COLUMN),
    (r"^to_out\.0\.weight$", ROW),
    (r"^net\.0\.proj\.(weight|bias)$", GEGLU),
    (r"^net\.2\.weight$", ROW),
    (r"^(conv1|time_emb_proj|norm2)\.(weight|bias)$", COLUMN),
    (r"^conv2\.weight$", ROW),
)


def param_sharding_spec(name: str) -> Optional[str]:
    """How a parameter (``name`` inside its block) is cut over tp when its
    block is sharded: COLUMN, ROW or GEGLU, or None (replicated)."""
    for pattern, spec in _TP_RULES:
        if re.search(pattern, name):
            return spec
    return None


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """What a sharded block needs to meet its tp peers."""

    size: int
    rank: int
    group: Optional[Any] = dataclasses.field(default=None, compare=False, repr=False)


@dataclasses.dataclass
class TPLayout:
    """A model's tensor-parallel layout: which blocks are sharded, and how
    each of their parameters is cut (``specs``, by parameter name)."""

    tp: int
    rank: int
    blocks: Dict[str, bool]
    specs: Dict[str, str]
    group: Optional[TPGroup] = None  # set by shard_params


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the tp
    group (each rank's column slab gave only its part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    """Sums the row-parallel partials over the tp group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def tp_copy(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """The replicated input of column-parallel layers (no-op unsharded)."""
    return x if tp is None else _CopyToTP.apply(x, tp.group)


def tp_reduce(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """The sum of row-parallel partials over the tp group, in place."""
    return x if tp is None else _ReduceFromTP.apply(x, tp.group)


def row_linear(x: torch.Tensor, layer: nn.Linear, tp: Optional[TPGroup]) -> torch.Tensor:
    """``layer(x)``; sharded, this rank's partial product in fp32 (a bf16
    GEMM with an fp32 output on the card), summed over the tp group in
    fp32, the bias added, then one rounding to x's dtype: as the unsharded
    bf16 GEMM rounds its fp32 accumulator once, bias included; rounding
    each partial and their sum as well would add roundings a block."""
    if tp is None:
        return layer(x)
    # the parameters in x's dtype, as the unsharded layer takes them
    weight = layer.weight.to(x.dtype)
    if x.dtype == torch.float32:
        partial = F.linear(x, weight)
    elif x.is_cuda:
        partial = torch.mm(x.reshape(-1, x.shape[-1]), weight.t(),
                           out_dtype=torch.float32).reshape(*x.shape[:-1], -1)
    else:
        partial = F.linear(x.float(), weight.float())
    out = tp_reduce(partial, tp)
    if layer.bias is not None:
        out = out + layer.bias.to(x.dtype).float()
    return out.to(x.dtype)


def _cuts(n: int, spec: str, rank: int, tp: int) -> Tuple[Tuple[int, int], ...]:
    """(start, length) runs of an axis of size ``n`` that ``rank`` holds."""
    if spec == GEGLU:
        per = n // 2 // tp
        return (rank * per, per), (n // 2 + rank * per, per)
    per = n // tp
    return ((rank * per, per),)


def _axis(spec: str) -> int:
    return 1 if spec == ROW else 0


def take_slab(full: torch.Tensor, spec: str, rank: int, tp: int) -> torch.Tensor:
    """This rank's slab of an unsharded parameter: a contiguous copy."""
    axis = _axis(spec)
    parts = [full.narrow(axis, s, n) for s, n in _cuts(full.shape[axis], spec, rank, tp)]
    return torch.cat(parts, axis) if len(parts) > 1 else parts[0].clone()


def gather_slab(slab: torch.Tensor, spec: str, tp: TPGroup) -> torch.Tensor:
    """The unsharded tensor from every rank's slab (a collective over the
    tp group): each rank places its slab in zeros, and one ``all_reduce``
    sums them, exactly, since every element has one nonzero term."""
    axis = _axis(spec)
    shape = list(slab.shape)
    shape[axis] *= tp.size
    full = slab.new_zeros(shape)
    offset = 0
    for s, n in _cuts(shape[axis], spec, tp.rank, tp.size):
        full.narrow(axis, s, n).copy_(slab.narrow(axis, offset, n))
        offset += n
    dist.all_reduce(full, group=tp.group)
    return full


def tp_plan(model: nn.Module, tp: int, rank: int = 0) -> TPLayout:
    """The layout ``shard_params`` gives ``model`` at ``tp`` ranks: every
    block (a module with ``tp_divides``) whose dims tp divides is sharded,
    all its parameters that the rules name cut; the rest replicated. Works
    on a ``meta`` model (no memory)."""
    blocks, specs = {}, {}
    for name, module in model.named_modules():
        if not hasattr(module, "tp_divides"):
            continue
        blocks[name] = tp > 1 and module.tp_divides(tp)
        if not blocks[name]:
            continue
        for pname, _ in module.named_parameters():
            spec = param_sharding_spec(pname)
            if spec is not None:
                specs[f"{name}.{pname}" if name else pname] = spec
    return TPLayout(tp, rank, blocks, specs)


def shard_params(model: nn.Module, mesh) -> TPLayout:
    """Cut a full model, identical on every rank (same seed or checkpoint),
    to this tp rank's slabs in place, and hand each sharded block its tp
    group. Build the optimizer after this. Returns the layout, also kept as
    ``model.tp_layout`` (checkpoints gather and cut by it). The conv weights'
    slabs are laid out channels-last again (``channels_last_convs_``)."""
    layout = tp_plan(model, mesh.tp, mesh.tp_rank)
    group = layout.group = TPGroup(mesh.tp, mesh.tp_rank, mesh.tp_group)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, spec in layout.specs.items():
            p = params[name]
            p.data = take_slab(p.data, spec, mesh.tp_rank, mesh.tp)
    channels_last_convs_(model)
    modules = dict(model.named_modules())
    for name, sharded in layout.blocks.items():
        if sharded:
            modules[name].tp = group
    model.tp_layout = layout
    return layout


def unsharded(model: nn.Module, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``tensors`` (by parameter name, each shaped as this rank's slab of
    that parameter) made whole: a collective over the tp group of a model
    cut by ``shard_params``, where every tp rank passes the same names. An
    unsharded model's come back as they are."""
    layout = getattr(model, "tp_layout", None)
    if layout is None or layout.tp == 1:
        return dict(tensors)
    return {n: gather_slab(t, layout.specs[n], layout.group) if n in layout.specs else t
            for n, t in tensors.items()}


def resharded(model: nn.Module, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Unsharded ``tensors`` (by parameter name) cut to this rank's slabs of
    ``model``'s layout (themselves where the model is unsharded)."""
    layout = getattr(model, "tp_layout", None)
    if layout is None or layout.tp == 1:
        return dict(tensors)
    return {n: take_slab(t, layout.specs[n], layout.rank, layout.tp) if n in layout.specs else t
            for n, t in tensors.items()}


def sync_replicated_grads(model: nn.Module) -> None:
    """Average the gradients of the parameters that every tp rank holds
    whole (norms, the transformers' ``proj_in``/``proj_out``, row layers'
    biases) over the tp group, in place: one ``all_reduce`` of them all.
    Each rank computes the same gradient from the same activations, but the
    card's reductions with atomics (a conv's weight gradient, an indexed
    add) may sum in another order on each, and the replicas would drift
    apart step by step; the average of equal values is each of them."""
    layout = getattr(model, "tp_layout", None)
    if layout is None or layout.tp == 1:
        return
    grads = [p.grad for n, p in model.named_parameters()
             if n not in layout.specs and p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=layout.group.group)
    flat /= layout.tp
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def sharded_fraction(model: nn.Module, layout: TPLayout, pattern: str = "") -> float:
    """The share of the (unsharded) parameter bytes of ``model`` whose names
    match ``pattern`` that ``layout`` cuts over tp, as the JAX package's
    ``flagship_stream_tp_check`` counts them (a sharded parameter's whole
    size counts). Call it before ``shard_params`` (or on a meta model)."""
    total = on_tp = 0
    for name, p in model.named_parameters():
        if re.search(pattern, name):
            nbytes = p.numel() * p.element_size()
            total += nbytes
            on_tp += nbytes if name in layout.specs else 0
    return on_tp / total
