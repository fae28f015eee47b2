"""Checkpoint state dicts -> the port's modules, by name.

The port's counterpart of the JAX builder's key maps plus
``_merge_into_shapes`` (``live2diff_tpu/builder.py:451-471``). The port's
modules already carry the checkpoint names (diffusers / AnimateDiff for
the UNet, diffusers ``vae/`` for the KL codec, ``encoder.N`` /
``decoder.N`` for TAESD, the MiDaS names for the DPT, HF ``text_model.*``
for CLIP), so each module parameter takes the tensor of its own name. The
one rename is ``vae_state_dict``'s, for older diffusers VAE files. A key that names no
parameter is not used; that covers what the JAX maps drop (the motion
modules' ``pos_encoder.pe`` tables, the DPT's unused
``scratch.refinenet4.resConfUnit1``, HF's ``position_ids``).

A module is built on the ``meta`` device, so nothing is allocated or drawn
twice: each parameter is written once on its device, from the checkpoint
(cast to the module's dtype by the copy: a checkpoint is loaded into the
pipeline's ``dtype``, the one the modules compute in) or, where no file
supplied it, from the pipeline's generator as N(0, 0.02^2).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

PLACEHOLDER_SCALE = 0.02

# older diffusers VAE files name the mid-block attention's projections so,
# and may store them as 1x1 convs (live2diff_tpu/convert/torch_to_flax.py:308-313)
_OLD_VAE_ATTENTION = re.compile(
    r"^(.*\.attentions\.\d+)\.(query|key|value|proj_attn)\.(weight|bias)$")
_OLD_VAE_NAMES = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}
_VAE_LINEAR = re.compile(r"\.attentions\.\d+\.(to_q|to_k|to_v|to_out\.0)\.weight$")


def vae_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A diffusers ``vae/`` state dict in the port's ``AutoencoderKL`` names:
    ``query``/``key``/``value``/``proj_attn`` become ``to_q``/``to_k``/
    ``to_v``/``to_out.0``, and a ``[C, C, 1, 1]`` projection weight the
    linear's ``[C, C]``."""
    out = {}
    for key, t in sd.items():
        m = _OLD_VAE_ATTENTION.match(key)
        if m:
            key = f"{m.group(1)}.{_OLD_VAE_NAMES[m.group(2)]}.{m.group(3)}"
        if _VAE_LINEAR.search(key) and t.dim() == 4:
            t = t[:, :, 0, 0]
        out[key] = t
    return out


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
    """``make()`` on the meta device, materialised on ``device`` in ``dtype``
    (the pipeline's, which the modules compute in).
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
