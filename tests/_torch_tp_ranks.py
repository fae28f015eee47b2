"""The ranked half of tests/test_torch_parallel_tp.py: what each of two gloo
ranks computes (imports no JAX; the test writes the inputs, ``inputs.pt``,
and reads ``rank<r>.pt``)."""

from __future__ import annotations

import os

import torch
from torch import nn

from live2diff_tpu_torch.models.layers import GEGLUFeedForward
from live2diff_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from live2diff_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state
from live2diff_tpu_torch.parallel.infer import run_stream
from live2diff_tpu_torch.parallel.mesh import batch_shard, make_mesh
from live2diff_tpu_torch.parallel.tp import shard_params, unsharded
from live2diff_tpu_torch.parallel.train import (
    TrainState, is_motion_param, make_optimizer, make_train_step,
)
from live2diff_tpu_torch.train import TINY_UNET
from live2diff_tpu_torch.utils.timing import RECORDER

TRAIN_UNET = dict(TINY_UNET, layers_per_block=1)
LR, WD = 1e-3, 0.01


class FF(nn.Module):
    """A feed-forward under the UNet's key (``ff``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x):
        return self.ff(x)


def train_state(sd, mesh):
    """The train UNet from ``sd``, cut over ``mesh``, its optimizer and state."""
    unet = UNet3DConditionModel(UNetConfig(**TRAIN_UNET))
    unet.load_state_dict(sd, strict=True)
    shard_params(unet, mesh)
    optimizer = make_optimizer(unet, LR, WD)
    return TrainState(0, unet, optimizer, torch.Generator().manual_seed(5))


def moments(state):
    """AdamW's first moments by parameter name (this rank's slabs)."""
    by_id = {id(p): n for n, p in state.unet.named_parameters()}
    return {by_id[id(p)]: s["exp_avg"] for p, s in state.optimizer.state.items()}


def train_run(mesh, data, save_dir=None) -> dict:
    """One step on this dp rank's rows, with the injected t and noise; the
    loss, and the motion gradients, parameters and first moments made whole."""
    state = train_state(data["train_sd"], mesh)
    local = {k: batch_shard(mesh, v) for k, v in data["train_batch"].items()}
    step = make_train_step(state.unet, state.optimizer, mesh)
    batch = {k: local[k] for k in ("latents", "text", "depth")}
    state, loss = step(state, batch, t=local["t"], noise=local["noise"])
    motion = [(n, p) for n, p in state.unet.named_parameters() if is_motion_param(n)]
    out = {"loss": float(loss),
           "grads": unsharded(state.unet, {n: p.grad for n, p in motion}),
           "params": unsharded(state.unet, {n: p.detach() for n, p in motion}),
           "exp_avg": unsharded(state.unet, moments(state))}
    if save_dir:
        save_train_state(save_dir, state, write=mesh.rank == 0)
    return out


def ranked(rank: int, out_dir: str) -> None:
    data = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=True)
    mesh = make_mesh()
    assert (mesh.dp, mesh.tp, mesh.tp_rank) == (1, 2, rank)
    res = {}
    with torch.no_grad():
        ff = FF(16)
        ff.load_state_dict(data["ff_sd"])
        shard_params(ff, mesh)
        res["ff"] = ff(data["ff_x"])
        res["ff_slab"] = ff.ff.net[0].proj.weight.clone()

    unet = UNet3DConditionModel(UNetConfig(**TINY_UNET))
    unet.load_state_dict(data["stream_sd"], strict=True)
    shard_params(unet, mesh)
    res["stream_conv_layouts"] = {
        n: m.weight.is_contiguous(memory_format=torch.channels_last)
        for n, m in unet.named_modules() if isinstance(m, nn.Conv2d)}
    caches = unet.config.init_caches(8, 8, 2, torch.float32, tp=mesh.tp)
    relayouts = RECORDER.summary(0)["counters"].get("conv_weight_relayouts", 0)
    outs, caches, _ = run_stream(unet, caches, data["stream_inputs"])
    res["stream"], res["stream_caches"] = outs, caches
    res["stream_relayouts"] = (RECORDER.summary(0)["counters"].get("conv_weight_relayouts", 0)
                               - relayouts)

    res["train_tp"] = train_run(mesh, data, os.path.join(out_dir, "ckpt_tp2"))
    res["train_dp"] = train_run(make_mesh(dp=2, tp=1), data)

    state = train_state(data["train_sd"], mesh)  # a fresh state resumes the tp = 1 save
    restore_train_state(data["ckpt_tp1"], state)
    res["resumed"] = {n: p.detach() for n, p in state.unet.named_parameters()
                      if is_motion_param(n)}
    res["resumed_exp_avg"] = moments(state)
    res["resumed_step"] = state.step
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
