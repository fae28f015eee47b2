"""Checkpoint state dicts -> the port's modules, by name.

The port's counterpart of the JAX builder's key maps plus
``_merge_into_shapes`` (``live2diff_tpu/builder.py:451-471``). The port's
modules already carry the checkpoint names (diffusers / AnimateDiff for
the UNet, ``encoder.N`` / ``decoder.N`` for TAESD, the MiDaS names for the
DPT, HF ``text_model.*`` for CLIP), so nothing is renamed here: each
module parameter takes the tensor of its own name. A key that names no
parameter is not used; that covers what the JAX maps drop (the motion
modules' ``pos_encoder.pe`` tables, the DPT's unused
``scratch.refinenet4.resConfUnit1``, HF's ``position_ids``).

A module is built on the ``meta`` device, so nothing is allocated or drawn
twice: each parameter is written once on its device, from the checkpoint
(cast to the module's dtype by the copy) or, where no file supplied it,
from the pipeline's generator as N(0, 0.02^2).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch import nn

PLACEHOLDER_SCALE = 0.02


def load_into(module: nn.Module, sd: Dict[str, torch.Tensor], missing: List[str]
              ) -> List[str]:
    """Copy ``sd`` into ``module``'s parameters by name, in place. Each
    parameter no tensor supplied is reported as ``param:<name>``, a shape
    that differs as ``shape-mismatch:<name> <got> vs <expected>``, in
    ``missing``. Returns the names of the parameters left unwritten."""
    unwritten = []
    with torch.no_grad():
        for name, p in module.named_parameters():
            t = sd.get(name)
            if t is None:
                missing.append(f"param:{name}")
            elif tuple(t.shape) != tuple(p.shape):
                missing.append(f"shape-mismatch:{name} {tuple(t.shape)} vs {tuple(p.shape)}")
            else:
                p.copy_(t)
                continue
            unwritten.append(name)
    return unwritten


def build_module(make: Callable[[], nn.Module], device: torch.device, dtype: torch.dtype,
                 generator: torch.Generator, sd: Optional[Dict[str, torch.Tensor]] = None,
                 missing: Optional[List[str]] = None) -> nn.Module:
    """``make()`` on the meta device, materialised on ``device`` in ``dtype``.
    With a state dict, its tensors fill the parameters they name (see
    ``load_into``) and the rest are drawn from ``generator``; without one
    every parameter is drawn, in the module's parameter order. Returns the
    module in eval mode without gradients."""
    with torch.device("meta"):
        module = make()
    module = module.to(dtype=dtype).to_empty(device=device)
    draw = None if sd is None else set(load_into(module, sd, missing))
    with torch.no_grad():
        for name, p in module.named_parameters():
            if draw is None or name in draw:
                p.normal_(0.0, PLACEHOLDER_SCALE, generator=generator)
    return module.eval().requires_grad_(False)
