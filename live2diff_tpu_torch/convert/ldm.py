"""LDM ("CompVis") checkpoint -> diffusers-layout key remap.

Port of ``live2diff_tpu/convert/ldm.py``, on torch tensors. DreamBooth
community checkpoints (``third_party_dict.dreambooth`` in a style config,
e.g. disneyPixarCartoon_v10.safetensors) ship in the original LDM layout.
This module renames their keys to the diffusers layout that the port's
modules carry; only the VAE's 1x1-conv attention projections change shape
(to linear weights).

SD-1.5 structure assumed: 4 down / 4 up blocks, 2 resnets per down block,
3 per up block, attention in blocks at resolutions 1/2/4.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import torch

UNET_PREFIX = "model.diffusion_model."
VAE_PREFIX = "first_stage_model."
CLIP_PREFIX = "cond_stage_model.transformer."


def _remap_ldm_resnet(tail: str) -> str | None:
    table = {
        "in_layers.0": "norm1",
        "in_layers.2": "conv1",
        "emb_layers.1": "time_emb_proj",
        "out_layers.0": "norm2",
        "out_layers.3": "conv2",
        "skip_connection": "conv_shortcut",
    }
    for src, dst in table.items():
        if tail.startswith(src + "."):
            return dst + tail[len(src):]
    return None


def convert_ldm_unet_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """LDM UNet keys -> diffusers UNet keys."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in sd.items():
        if not key.startswith(UNET_PREFIX):
            continue
        k = key[len(UNET_PREFIX):]

        m = re.match(r"^time_embed\.(0|2)\.(weight|bias)$", k)
        if m:
            out[f"time_embedding.linear_{1 if m.group(1) == '0' else 2}.{m.group(2)}"] = val
            continue
        m = re.match(r"^input_blocks\.0\.0\.(weight|bias)$", k)
        if m:
            out[f"conv_in.{m.group(1)}"] = val
            continue
        m = re.match(r"^out\.0\.(weight|bias)$", k)
        if m:
            out[f"conv_norm_out.{m.group(1)}"] = val
            continue
        m = re.match(r"^out\.2\.(weight|bias)$", k)
        if m:
            out[f"conv_out.{m.group(1)}"] = val
            continue

        m = re.match(r"^input_blocks\.(\d+)\.(\d+)\.(.*)$", k)
        if m:
            i, unit, tail = int(m.group(1)), int(m.group(2)), m.group(3)
            block_id, layer = (i - 1) // 3, (i - 1) % 3
            if layer == 2:  # downsampler slot
                m2 = re.match(r"^op\.(weight|bias)$", tail)
                if m2:
                    out[f"down_blocks.{block_id}.downsamplers.0.conv.{m2.group(1)}"] = val
                continue
            if unit == 0:
                mapped = _remap_ldm_resnet(tail)
                if mapped:
                    out[f"down_blocks.{block_id}.resnets.{layer}.{mapped}"] = val
            else:
                out[f"down_blocks.{block_id}.attentions.{layer}.{tail}"] = val
            continue

        m = re.match(r"^middle_block\.(\d+)\.(.*)$", k)
        if m:
            unit, tail = int(m.group(1)), m.group(2)
            if unit in (0, 2):
                mapped = _remap_ldm_resnet(tail)
                if mapped:
                    out[f"mid_block.resnets.{0 if unit == 0 else 1}.{mapped}"] = val
            else:
                out[f"mid_block.attentions.0.{tail}"] = val
            continue

        m = re.match(r"^output_blocks\.(\d+)\.(\d+)\.(.*)$", k)
        if m:
            i, unit, tail = int(m.group(1)), int(m.group(2)), m.group(3)
            block_id, layer = i // 3, i % 3
            if unit == 0:
                mapped = _remap_ldm_resnet(tail)
                if mapped:
                    out[f"up_blocks.{block_id}.resnets.{layer}.{mapped}"] = val
                continue
            # unit >= 1: attention or upsampler. Upsamplers sit in the LAST
            # layer of non-final blocks; on blocks with attention they are
            # unit 2, on the attention-free block (up 0) they are unit 1.
            if tail.startswith("conv.") and layer == 2:
                out[f"up_blocks.{block_id}.upsamplers.0.{tail}"] = val
            else:
                out[f"up_blocks.{block_id}.attentions.{layer}.{tail}"] = val
            continue
    return out


def convert_ldm_vae_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """LDM VAE keys -> diffusers AutoencoderKL keys."""
    out: Dict[str, torch.Tensor] = {}
    num_up = 4
    for key, val in sd.items():
        if not key.startswith(VAE_PREFIX):
            continue
        k = key[len(VAE_PREFIX):]
        m = re.match(r"^(quant_conv|post_quant_conv)\.(weight|bias)$", k)
        if m:
            out[k] = val
            continue
        m = re.match(r"^(encoder|decoder)\.(.*)$", k)
        if not m:
            continue
        tower, tail = m.groups()

        tail = tail.replace("norm_out.", "conv_norm_out.")
        m2 = re.match(r"^down\.(\d+)\.block\.(\d+)\.(.*)$", tail)
        if m2:
            i, j, rest = m2.groups()
            rest = rest.replace("nin_shortcut.", "conv_shortcut.")
            out[f"{tower}.down_blocks.{i}.resnets.{j}.{rest}"] = val
            continue
        m2 = re.match(r"^down\.(\d+)\.downsample\.conv\.(weight|bias)$", tail)
        if m2:
            out[f"{tower}.down_blocks.{m2.group(1)}.downsamplers.0.conv.{m2.group(2)}"] = val
            continue
        m2 = re.match(r"^up\.(\d+)\.block\.(\d+)\.(.*)$", tail)
        if m2:
            i, j, rest = int(m2.group(1)), m2.group(2), m2.group(3)
            rest = rest.replace("nin_shortcut.", "conv_shortcut.")
            # LDM numbers decoder up blocks fine->coarse; diffusers coarse->fine
            out[f"{tower}.up_blocks.{num_up - 1 - i}.resnets.{j}.{rest}"] = val
            continue
        m2 = re.match(r"^up\.(\d+)\.upsample\.conv\.(weight|bias)$", tail)
        if m2:
            i = int(m2.group(1))
            out[f"{tower}.up_blocks.{num_up - 1 - i}.upsamplers.0.conv.{m2.group(2)}"] = val
            continue
        m2 = re.match(r"^mid\.block_(\d)\.(.*)$", tail)
        if m2:
            rest = m2.group(2).replace("nin_shortcut.", "conv_shortcut.")
            out[f"{tower}.mid_block.resnets.{int(m2.group(1)) - 1}.{rest}"] = val
            continue
        m2 = re.match(r"^mid\.attn_1\.(.*)$", tail)
        if m2:
            rest = m2.group(1)
            name_map = {"norm": "group_norm", "q": "to_q", "k": "to_k", "v": "to_v",
                        "proj_out": "to_out.0"}
            mm = re.match(r"^(norm|q|k|v|proj_out)\.(weight|bias)$", rest)
            if mm:
                name, leaf = mm.groups()
                arr = val
                if name in ("q", "k", "v", "proj_out") and leaf == "weight" and arr.ndim == 4:
                    arr = arr[:, :, 0, 0]  # 1x1 conv -> linear
                out[f"{tower}.mid_block.attentions.0.{name_map[name]}.{leaf}"] = arr
            continue
        m2 = re.match(r"^(conv_in|conv_out|conv_norm_out)\.(weight|bias)$", tail)
        if m2:
            out[f"{tower}.{m2.group(1)}.{m2.group(2)}"] = val
            continue
    return out


def convert_ldm_clip_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """LDM CLIP keys ('cond_stage_model.transformer.text_model...') -> HF keys."""
    out = {}
    for key, val in sd.items():
        if key.startswith(CLIP_PREFIX):
            out[key[len(CLIP_PREFIX):]] = val
    return out


def convert_ldm_checkpoint(
    sd: Dict[str, torch.Tensor],
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Full LDM checkpoint -> (unet_sd, vae_sd, clip_sd) in diffusers layout."""
    return convert_ldm_unet_keys(sd), convert_ldm_vae_keys(sd), convert_ldm_clip_keys(sd)
