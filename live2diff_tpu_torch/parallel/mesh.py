"""Data parallelism over the clip axis, on ``torch.distributed``.

Port of the data-parallel half of ``live2diff_tpu/parallel/mesh.py``. The
JAX package lays the devices out as a (dp, tp) mesh and lets GSPMD insert
the collectives; the port runs one process a card (or a CPU process under
gloo), each with a whole replica of the UNet, a slice of the clip batch
(``batch_shard``, the counterpart of ``batch_sharding``, ``mesh.py:113``)
and ``DistributedDataParallel`` averaging the gradients over the ranks:
gloo on the CPU, NCCL on cards. The caller starts the process group
(``torch.distributed.init_process_group`` with its own address, world size
and rank); without one the run is a single rank.

Tensor parallelism (``_TP_RULES``, ``shard_params``) is ROADMAP item 9's
remainder: ``make_mesh(tp > 1)`` raises.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn


@dataclasses.dataclass(frozen=True)
class DataParallelMesh:
    """This process's place among the data-parallel ranks."""

    rank: int = 0
    world_size: int = 1

    @property
    def distributed(self) -> bool:
        return self.world_size > 1


def make_mesh(tp: int = 1) -> DataParallelMesh:
    """The data-parallel layout of the running process group (one rank
    when there is none)."""
    if tp != 1:
        raise NotImplementedError(
            f"tp={tp}: tensor parallelism is not ported yet (ROADMAP item 9); "
            "the port trains data-parallel only")
    if dist.is_available() and dist.is_initialized():
        return DataParallelMesh(dist.get_rank(), dist.get_world_size())
    return DataParallelMesh()


def batch_shard(mesh: DataParallelMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch (the leading axis), which must
    split evenly over the ranks."""
    b = x.shape[0]
    if b % mesh.world_size:
        raise ValueError(f"batch {b} does not split over {mesh.world_size} ranks")
    per = b // mesh.world_size
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def wrap_model(module: nn.Module, mesh: DataParallelMesh) -> nn.Module:
    """``module`` under ``DistributedDataParallel`` when there are several
    ranks (its trainable parameters' gradients averaged over them in the
    backward), else ``module`` itself."""
    if not mesh.distributed:
        return module
    from torch.nn.parallel import DistributedDataParallel

    device = next(module.parameters()).device
    return DistributedDataParallel(
        module, device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False)


def average(mesh: DataParallelMesh, x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks (``x`` itself on one rank)."""
    if not mesh.distributed:
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x / mesh.world_size
