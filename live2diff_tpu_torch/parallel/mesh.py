"""The (dp, tp) mesh over ``torch.distributed``.

Port of ``live2diff_tpu/parallel/mesh.py``. The JAX package lays the
devices out as a (dp, tp) mesh and lets GSPMD insert the collectives; the
port runs one process a card (or a CPU process under gloo) and writes the
collectives out:

* dp, data parallel: each dp rank takes a slice of the clip batch
  (``batch_shard``, the counterpart of ``batch_sharding``, ``mesh.py:113``)
  or of the sessions, and ``DistributedDataParallel`` averages the
  gradients over the dp group;
* tp, tensor parallel: the ranks of a tp group hold slabs of the attention,
  feed-forward and resnet weights (``parallel/tp.py``) and meet in one
  ``all_reduce`` a block.

Global rank ``r`` sits at ``(r // tp, r % tp)``, as ``np.reshape(devices,
(dp, tp))`` places the JAX package's devices, so a tp group is ``tp``
consecutive ranks. The caller starts the process group
(``torch.distributed.init_process_group`` with its own address, world size
and rank; gloo on the CPU, NCCL across cards); without one the run is a
single rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the (dp, tp) mesh, and its two groups (None
    where the axis has one rank)."""

    dp: int = 1
    tp: int = 1
    rank: int = 0  # the global rank
    dp_group: Optional[Any] = dataclasses.field(default=None, compare=False, repr=False)
    tp_group: Optional[Any] = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def world_size(self) -> int:
        return self.dp * self.tp


def default_split(n: int, dp: Optional[int] = None, tp: Optional[int] = None) -> Tuple[int, int]:
    """(dp, tp) over ``n`` ranks, as ``live2diff_tpu/parallel/mesh.py:23-46``
    splits devices: as much tp as divides ``n`` up to 8, the rest dp."""
    if tp is None:
        tp = next((c for c in (8, 4, 2) if n % c == 0), 1)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp ({dp}*{tp}) != ranks ({n})")
    return dp, tp


def group_ranks(dp: int, tp: int) -> Tuple[List[List[int]], List[List[int]]]:
    """The global ranks of every dp group (one a tp rank) and every tp group
    (one a dp rank)."""
    return ([[d * tp + t for d in range(dp)] for t in range(tp)],
            [[d * tp + t for t in range(tp)] for d in range(dp)])


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None) -> Mesh:
    """The (dp, tp) mesh over the running process group, with the JAX
    package's default split (one rank when there is no group). Every rank
    must call it with the same arguments: it makes every dp and tp group
    (``dist.new_group``) in the same order on each."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks over a process group of {world}")
    dp, tp = default_split(n, dp, tp)
    if world == 1:
        return Mesh()
    rank = dist.get_rank()
    dp_ranks, tp_ranks = group_ranks(dp, tp)
    dp_groups = [dist.new_group(r) for r in dp_ranks]
    tp_groups = [dist.new_group(r) for r in tp_ranks]
    return Mesh(dp, tp, rank,
                dp_group=dp_groups[rank % tp] if dp > 1 else None,
                tp_group=tp_groups[rank // tp] if tp > 1 else None)


def batch_shard(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This dp rank's rows of a global batch (the leading axis), which must
    split evenly over the dp ranks; the tp ranks of a dp group take the
    same rows."""
    b = x.shape[0]
    if b % mesh.dp:
        raise ValueError(f"batch {b} does not split over {mesh.dp} dp ranks")
    per = b // mesh.dp
    return x[mesh.dp_rank * per:(mesh.dp_rank + 1) * per]


def wrap_model(module: nn.Module, mesh: Mesh) -> nn.Module:
    """``module`` under ``DistributedDataParallel`` over the dp group when it
    has several ranks (its trainable parameters' gradients averaged over
    them in the backward), else ``module`` itself. The tp ranks are never
    in one DDP group: they hold different slabs."""
    if mesh.dp == 1:
        return module
    from torch.nn.parallel import DistributedDataParallel

    device = next(module.parameters()).device
    return DistributedDataParallel(
        module, device_ids=[device.index] if device.type == "cuda" else None,
        process_group=mesh.dp_group, broadcast_buffers=False)


def average(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the dp ranks (``x`` itself on one)."""
    if mesh.dp == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=mesh.dp_group)
    return x / mesh.dp
