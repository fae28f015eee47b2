"""Train-state checkpoints for the motion-module trainer.

Port of ``live2diff_tpu/parallel/checkpoint.py:27-69``. The JAX package
writes the whole TrainState with orbax; the port writes what training
changes, one ``torch.save`` file a checkpoint directory: the step, the
motion parameters, the AdamW state and the generator's state. The frozen
weights are not written (they come from the run's seed or checkpoint).
Loading is ``torch.load(..., weights_only=True)``: tensors and plain
containers only, never code.

The file holds unsharded tensors whatever the tp layout: a UNet cut by
``parallel/tp.shard_params`` gathers its slabs over the tp group to save
(a collective), and a resume cuts the file's
tensors to the loading rank's slabs, so a checkpoint saved at one tp
resumes at any other.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .tp import resharded, unsharded
from .train import TrainState, is_motion_param

STATE_FILE = "train_state.pt"


def _optimizer_names(state: TrainState):
    """The parameter name of each index of the optimizer's state dict."""
    name_of = {id(p): n for n, p in state.unet.named_parameters()}
    return [name_of[id(p)] for g in state.optimizer.param_groups for p in g["params"]]


def _map_moments(sd: dict, names, fn) -> dict:
    """The optimizer state dict ``sd`` with its per-parameter moments passed
    through ``fn`` (a dict of tensors by parameter name -> the same)."""
    state = {}
    for key in ("exp_avg", "exp_avg_sq"):
        mapped = fn({names[i]: s[key] for i, s in sd["state"].items() if key in s})
        for i, s in sd["state"].items():
            state.setdefault(i, dict(s))[key] = mapped[names[i]]
    return {**sd, "state": state}


def save_train_state(path: str, state: TrainState, write: bool = True) -> str:
    """Write ``state`` into directory ``path`` (made if missing; an
    existing checkpoint there is replaced whole). Returns the path. Under
    tp every rank of the tp group calls it (the gather is a collective) and
    one passes ``write=True``."""
    motion = {n: p.detach() for n, p in state.unet.named_parameters() if is_motion_param(n)}
    payload = {
        "step": int(state.step),
        "motion": unsharded(state.unet, motion),
        "optimizer": _map_moments(state.optimizer.state_dict(), _optimizer_names(state),
                                  lambda t: unsharded(state.unet, t)),
        "generator": state.generator.get_state(),
    }
    path = os.path.abspath(path)
    if not write:
        return path
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, STATE_FILE)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, target)
    return path


def restore_train_state(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint written by ``save_train_state`` into ``state`` (its
    UNet's motion parameters, its optimizer and generator, its step), in
    place, on the devices ``state`` lives on, each tensor cut to this
    rank's slab where the UNet is cut over tp. Returns ``state``."""
    payload = torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location="cpu",
                         weights_only=True)
    params = {n: p for n, p in state.unet.named_parameters() if is_motion_param(n)}
    if set(payload["motion"]) != set(params):
        raise ValueError(f"{path}: the checkpoint's motion parameters are not this UNet's")
    motion = resharded(state.unet, payload["motion"])
    with torch.no_grad():
        for name, p in params.items():
            if motion[name].shape != p.shape:
                raise ValueError(f"{path}: {name} is {tuple(motion[name].shape)} in the "
                                 f"checkpoint, {tuple(p.shape)} here")
            p.copy_(motion[name])
    state.optimizer.load_state_dict(_map_moments(
        payload["optimizer"], _optimizer_names(state), lambda t: resharded(state.unet, t)))
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    return state


def latest_step_dir(root: str) -> Optional[str]:
    """Newest ``step_<N>`` checkpoint directory under ``root`` (or None)."""
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_"):
            try:
                steps.append((int(name.split("_", 1)[1]), name))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(root, max(steps)[1])
