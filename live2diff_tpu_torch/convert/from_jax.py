"""Flax parameter trees (as numpy) -> the port's torch state dicts.

Carries the JAX package's weights across to the port, so the tests can run
both on the same parameters. The port's modules are named after the
diffusers / AnimateDiff / TAESD / KL-VAE checkpoint keys, which the JAX package's
own torch->flax converter maps from; this is the inverse of that map:

  Dense kernel [in, out]         -> Linear weight [out, in]
  Conv kernel [kh, kw, in, out]  -> Conv weight [out, in, kh, kw]
  norm scale                     -> weight
  Flax wrapper levels (InflatedConv's ``conv``, InflatedGroupNorm's
  ``norm``) are dropped; flattened names (``down_blocks_0_resnets_1``,
  ``to_out_0``, ``layers_5``, the KL VAE's
  ``down_blocks_0_downsamplers_0_conv``) become dotted torch paths.

The DPT depth model's tree takes ``dpt_torch_key`` instead: the inverse of
``live2diff_tpu/convert/midas.py:dpt_key_map``, onto the MiDaS checkpoint
names (``stem_conv`` -> ``pretrained.model.patch_embed.backbone.stem.conv``,
``vit_blocks_3/attn_qkv`` -> ``pretrained.model.blocks.3.attn.qkv``, ...);
``cls_token`` and ``pos_embed`` pass through unchanged.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

_RENAMES = (
    (re.compile(r"^(down_blocks|up_blocks)_(\d+)_motion_modules_(\d+)$"),
     r"\1.\2.motion_modules.\3.temporal_transformer"),
    # the KL VAE's resampling convs, one flax module each
    (re.compile(r"^(down_blocks|up_blocks)_(\d+)_(downsamplers|upsamplers)_0_conv$"),
     r"\1.\2.\3.0.conv"),
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


_BACKBONE = "pretrained.model.patch_embed.backbone"
# (pattern, replacement) on the dotted flax module path; the first match wins
_DPT_RENAMES = tuple((re.compile(p), r) for p, r in (
    (r"^stem_(conv|norm)$", _BACKBONE + r".stem.\1"),
    (r"^stages_(\d+)_blocks_(\d+)\.downsample_(conv|norm)$",
     _BACKBONE + r".stages.\1.blocks.\2.downsample.\3"),
    (r"^stages_(\d+)_blocks_(\d+)\.", _BACKBONE + r".stages.\1.blocks.\2."),
    (r"^patch_embed_proj$", "pretrained.model.patch_embed.proj"),
    (r"^$", "pretrained.model"),  # cls_token, pos_embed
    (r"^vit_blocks_(\d+)\.(attn|mlp)_(qkv|proj|fc1|fc2)$", r"pretrained.model.blocks.\1.\2.\3"),
    (r"^vit_blocks_(\d+)\.", r"pretrained.model.blocks.\1."),
    (r"^postprocess(3|4)_readout$", r"pretrained.act_postprocess\1.0.project.0"),
    (r"^postprocess(3|4)_proj$", r"pretrained.act_postprocess\1.3"),
    (r"^postprocess4_down$", "pretrained.act_postprocess4.4"),
    (r"^(layer\d_rn)$", r"scratch.\1"),
    (r"^refinenet(\d)\.res_conv_unit(\d)\.", r"scratch.refinenet\1.resConfUnit\2."),
    (r"^refinenet(\d)\.", r"scratch.refinenet\1."),
    (r"^head_conv1$", "scratch.output_conv.0"),
    (r"^head_conv2$", "scratch.output_conv.2"),
    (r"^head_conv3$", "scratch.output_conv.4"),
))


def dpt_torch_key(path: Tuple[str, ...]) -> str:
    """The port's DPT state-dict key (the MiDaS checkpoint name) for one
    flax parameter path of ``live2diff_tpu.models.midas.DPTDepthModel``."""
    *mods, leaf = [p for p in path if p != "params"]
    if len(mods) >= 2 and mods[-1] == "norm":
        mods = mods[:-1]  # GNReLU wrapper
    leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
    mod = ".".join(mods)
    for pattern, repl in _DPT_RENAMES:
        if pattern.search(mod):
            return f"{pattern.sub(repl, mod, count=1)}.{leaf}"
    raise KeyError(f"no DPT checkpoint name for flax path {path}")


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    """A C-contiguous copy of ``arr`` as a CPU tensor of its own dtype; a
    bfloat16 array (JAX's numpy extension type) goes by its bits."""
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _convert(arr: np.ndarray, leaf: str) -> np.ndarray:
    if leaf == "kernel" and arr.ndim == 4:
        return np.transpose(arr, (3, 2, 0, 1))
    if leaf == "kernel" and arr.ndim == 2:
        return arr.T
    return arr


def params_from_jax(
    params: Mapping, key: Callable[[Tuple[str, ...]], str] = torch_key
) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (leaves convertible by ``np.asarray``) -> a
    state dict for the matching port module on the CPU, each parameter in
    its own dtype (fp32, or a ``param_dtype`` of bf16). ``key`` names each
    parameter: ``torch_key`` for the UNet and TAESD, ``dpt_torch_key`` for
    the DPT."""
    return {key(path): _to_torch(_convert(np.asarray(leaf), path[-1]))
            for path, leaf in _flatten(params)}
