"""Data parallelism on the CPU: two gloo processes, each with half the clip
batch, against one process with the whole batch.

Each rank builds the same tiny UNet (same seed), takes its half of the
latents and text and, in the first step, its half of injected t and noise;
in the second step every rank draws t and noise from the same generator
over the global batch and keeps its rows (``parallel/train.py:
diffusion_loss``). DistributedDataParallel averages the gradients: the
average of the two half-batch means is the whole-batch mean, up to the
order of the sums. So after each step:

* the loss (averaged over the ranks) is the single process's within 1e-6;
* every motion gradient is within 1e-4 of its tensor's largest element
  (half-batch sums that cancel: 1.2e-5 was measured);
* every rank holds the same parameters, bit for bit, and they are the
  single process's within 1e-6 wherever the gradients so far are at least
  1e-5: AdamW moves an element by lr g / (|g| + eps) early on, so where |g|
  is near eps = 1e-8 the sums' rounding is multiplied by up to lr / eps;
  there the parameters are held within 2 lr a step.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from live2diff_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from live2diff_tpu_torch.parallel.mesh import (
    Mesh, batch_shard, default_split, group_ranks, make_mesh,
)
from live2diff_tpu_torch.parallel.train import (
    TrainState, is_motion_param, make_optimizer, make_train_step,
)
from live2diff_tpu_torch.train import TINY_UNET, init_weights_

WORLD = 2
B, F, LAT, L = 2, 4, 8, 7
TOL, GRAD_TOL, CLEAR = 1e-6, 1e-4, 1e-5
LR = 1e-3
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)


def _setup(mesh: Mesh):
    """The tiny UNet from seed 0 (every weight random, the zero-initialised
    ones too), its optimizer and state, and this rank's share of the batch
    and of step 1's t and noise."""
    unet = UNet3DConditionModel(UNetConfig(**TINY_UNET, cond_mapping=False))
    init_weights_(unet, torch.Generator().manual_seed(0))
    with torch.no_grad():  # a fresh motion module's proj_out is zero: draw it too
        for name, p in unet.named_parameters():
            if name.endswith("proj_out.weight"):
                p.normal_(0.0, 0.2, generator=torch.Generator().manual_seed(1))
    optimizer = make_optimizer(unet, lr=LR)
    state = TrainState(0, unet, optimizer, torch.Generator().manual_seed(5))
    rs = np.random.RandomState(0)
    glob = {"latents": rs.randn(B, F, LAT, LAT, 4), "text": rs.randn(B, L, 12),
            "t": rs.randint(0, 1000, B), "noise": rs.randn(B, F, LAT, LAT, 4)}
    local = {k: batch_shard(mesh, torch.from_numpy(v.astype(np.int64 if k == "t" else np.float32)))
             for k, v in glob.items()}
    return state, make_train_step(unet, optimizer, mesh), local


def _run(mesh: Mesh):
    """Two steps; the loss, the motion parameters and their gradients after each."""
    state, step, local = _setup(mesh)
    batch = {"latents": local["latents"], "text": local["text"]}
    out = []
    for injected in (True, False):
        kw = dict(t=local["t"], noise=local["noise"]) if injected else {}
        state, loss = step(state, batch, **kw)
        motion = [(n, p) for n, p in state.unet.named_parameters() if is_motion_param(n)]
        out.append({"loss": float(loss),
                    "params": {n: p.detach().clone() for n, p in motion},
                    "grads": {n: p.grad.clone() for n, p in motion}})
    return out


def worker(rank: int, port: int, path: str) -> None:
    """One rank of the gloo run (started as its own process)."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    try:
        mesh = make_mesh(dp=WORLD, tp=1)  # the default split would make world 2 tp = 2
        assert mesh == Mesh(WORLD, 1, rank) and mesh.dp_rank == rank and mesh.tp_group is None
        torch.save(_run(mesh), path)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_equal_one_process_on_the_whole_batch(tmp_path):
    port = _free_port()
    code = (f"import sys; sys.path.insert(0, {TESTS_DIR!r}); "
            "import test_torch_train_ddp as m; "
            "m.worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])")
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port),
                               str(tmp_path / f"rank{r}.pt")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs

    torch.set_num_threads(1)
    single = _run(Mesh())
    ranked = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True) for r in range(WORLD)]
    for s, one in enumerate(single):
        n_clear = n_all = 0
        for name, p in ranked[0][s]["params"].items():
            assert torch.equal(p, ranked[1][s]["params"][name]), (s, name)
        many = ranked[0][s]
        assert abs(one["loss"] - many["loss"]) <= TOL * abs(one["loss"]), s
        assert one["params"].keys() == many["params"].keys()
        for name, p in one["params"].items():
            g = one["grads"][name]
            assert (g - many["grads"][name]).abs().max() <= GRAD_TOL * g.abs().max(), (s, name)
            clear = torch.stack([st["grads"][name].abs() for st in single[:s + 1]]).amin(0)
            clear = clear >= CLEAR
            diff = (p - many["params"][name]).abs()
            assert diff.max() <= 2 * LR * (s + 1) * (1 + 1e-3), (s, name)
            worst = diff[clear].max().item() if clear.any() else 0.0
            assert worst <= TOL, (s, name, worst)
            n_clear += int(clear.sum())
            n_all += clear.numel()
        assert n_clear > 0.75 * n_all, (s, n_clear, n_all)  # most elements are held to TOL
    # the step moved the motion parameters
    state, _, _ = _setup(Mesh())
    moved = [(single[-1]["params"][n] - p.detach()).abs().max().item()
             for n, p in state.unet.named_parameters() if is_motion_param(n)]
    assert min(moved) > 0


def test_batch_shard_and_mesh():
    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(batch_shard(Mesh(3, 1, 1), x), x[2:4])
    assert torch.equal(batch_shard(Mesh(3, 2, 3), x), x[2:4])  # dp rank 1's tp ranks share them
    assert torch.equal(batch_shard(Mesh(), x), x)
    with pytest.raises(ValueError, match="split"):
        batch_shard(Mesh(4, 1, 0), x)
    assert make_mesh() == Mesh()  # no process group here: one rank
    # the JAX package's default split: as much tp as divides the ranks, up to 8
    assert [default_split(n) for n in (1, 2, 3, 4, 6, 8, 12, 16)] == [
        (1, 1), (1, 2), (3, 1), (1, 4), (3, 2), (1, 8), (3, 4), (2, 8)]
    assert default_split(8, dp=4, tp=2) == (4, 2) and default_split(4, tp=1) == (4, 1)
    with pytest.raises(ValueError, match="ranks"):
        default_split(8, dp=4)  # tp defaults to 8 whatever dp says, as in JAX
    with pytest.raises(ValueError, match="ranks"):
        make_mesh(tp=2)  # two tp ranks over a world of one
    # rank r sits at (r // tp, r % tp): a tp group is tp consecutive ranks
    dp_groups, tp_groups = group_ranks(3, 2)
    assert tp_groups == [[0, 1], [2, 3], [4, 5]] and dp_groups == [[0, 2, 4], [1, 3, 5]]
    assert (Mesh(3, 2, 5).dp_rank, Mesh(3, 2, 5).tp_rank) == (2, 1)
