"""Flax parameter trees (as numpy) -> the port's torch state dicts.

Carries the JAX package's weights across to the port, so the tests can run
both on the same parameters. The port's modules are named after the
diffusers / AnimateDiff / TAESD checkpoint keys, which the JAX package's
own torch->flax converter maps from; this is the inverse of that map:

  Dense kernel [in, out]         -> Linear weight [out, in]
  Conv kernel [kh, kw, in, out]  -> Conv weight [out, in, kh, kw]
  norm scale                     -> weight
  Flax wrapper levels (InflatedConv's ``conv``, InflatedGroupNorm's
  ``norm``) are dropped; flattened names (``down_blocks_0_resnets_1``,
  ``to_out_0``, ``layers_5``) become dotted torch paths.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_RENAMES = (
    (re.compile(r"^(down_blocks|up_blocks)_(\d+)_motion_modules_(\d+)$"),
     r"\1.\2.motion_modules.\3.temporal_transformer"),
    (re.compile(r"^(down_blocks|up_blocks)_(\d+)_(resnets|attentions|downsamplers|upsamplers)_(\d+)$"),
     r"\1.\2.\3.\4"),
    (re.compile(r"^mid_block_(resnets|attentions)_(\d+)$"), r"mid_block.\1.\2"),
    (re.compile(r"^(transformer_blocks|attention_blocks|norms|blocks)_(\d+)$"), r"\1.\2"),
    (re.compile(r"^layers_(\d+)$"), r"\1"),  # TAESD Sequential slots
    (re.compile(r"^conv_(\d+)$"), r"conv.\1"),  # TAESD Block convs
    (re.compile(r"^to_out_0$"), "to_out.0"),
    (re.compile(r"^net_0_proj$"), "net.0.proj"),
    (re.compile(r"^net_2$"), "net.2"),
    (re.compile(r"^op$"), "conv"),  # Downsample3D's conv
)

# InflatedGroupNorm wraps its GroupNorm in a "norm" child under these names
_GN_WRAPPED = {"norm1", "norm2", "conv_norm_out"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _rename(part: str) -> str:
    for pattern, repl in _RENAMES:
        if pattern.match(part):
            return pattern.sub(repl, part)
    return part


def torch_key(path: Tuple[str, ...]) -> str:
    """The port's state-dict key for one flax parameter path."""
    parts = [p for p in path if p != "params"]
    *mods, leaf = parts
    if len(mods) >= 2 and mods[-1] == "conv":
        mods = mods[:-1]  # InflatedConv wrapper
    elif len(mods) >= 2 and mods[-1] == "norm" and mods[-2] in _GN_WRAPPED:
        mods = mods[:-1]  # InflatedGroupNorm wrapper
    leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
    return ".".join([_rename(m) for m in mods] + [leaf])


def _convert(arr: np.ndarray, leaf: str) -> np.ndarray:
    if leaf == "kernel" and arr.ndim == 4:
        return np.transpose(arr, (3, 2, 0, 1))
    if leaf == "kernel" and arr.ndim == 2:
        return arr.T
    return arr


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (leaves convertible by ``np.asarray``) -> a
    state dict for the matching port module, fp32 on the CPU."""
    out = {}
    for path, leaf in _flatten(params):
        arr = _convert(np.asarray(leaf, dtype=np.float32), path[-1])
        out[torch_key(path)] = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return out
