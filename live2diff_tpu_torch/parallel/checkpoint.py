"""Train-state checkpoints for the motion-module trainer.

Port of ``live2diff_tpu/parallel/checkpoint.py:27-69``. The JAX package
writes the whole TrainState with orbax; the port writes what training
changes, one ``torch.save`` file a checkpoint directory: the step, the
motion parameters, the AdamW state and the generator's state. The frozen
weights are not written (they come from the run's seed or checkpoint).
Loading is ``torch.load(..., weights_only=True)``: tensors and plain
containers only, never code.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .train import TrainState, is_motion_param

STATE_FILE = "train_state.pt"


def save_train_state(path: str, state: TrainState) -> str:
    """Write ``state`` into directory ``path`` (made if missing; an
    existing checkpoint there is replaced whole). Returns the path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    payload = {
        "step": int(state.step),
        "motion": {n: p.detach() for n, p in state.unet.named_parameters()
                   if is_motion_param(n)},
        "optimizer": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
    }
    target = os.path.join(path, STATE_FILE)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, target)
    return path


def restore_train_state(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint written by ``save_train_state`` into ``state`` (its
    UNet's motion parameters, its optimizer and generator, its step), in
    place, on the devices ``state`` lives on. Returns ``state``."""
    payload = torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location="cpu",
                         weights_only=True)
    params = {n: p for n, p in state.unet.named_parameters() if is_motion_param(n)}
    if set(payload["motion"]) != set(params):
        raise ValueError(f"{path}: the checkpoint's motion parameters are not this UNet's")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(payload["motion"][name])
    state.optimizer.load_state_dict(payload["optimizer"])
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
