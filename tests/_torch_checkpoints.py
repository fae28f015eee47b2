"""Synthetic checkpoints in the real files' key layouts, for the port's
ingest tests (tests/test_torch_{builder,wrapper,cli}.py).

No real weights are available, so a complete set is written for the tiny
UNet of tests/test_builder.py (``TINY_OVERRIDES``): SD-1.5's
``unet/diffusion_pytorch_model.safetensors`` (SD keys only), a motion-module
``.ckpt`` (a ``state_dict`` wrapper, ``module.`` prefixes, a ``grid`` buffer
and ``pos_encoder.pe`` tables), a DreamBooth checkpoint in the LDM layout,
a kohya-style LoRA (3x3 conv and linear), a peft-style LCM-LoRA (three key
dialects) and a TAESD file. No 1x1-conv LoRA: the JAX merge raises on one
(its ``_delta`` einsum repeats an output subscript), so those are held to
a direct product in tests/test_torch_ingest.py instead. Key names and
shapes come from the port's modules (which carry the checkpoint names);
values are numpy draws from fixed seeds: weights N(0, 1/fan_in), norm
scales 1 + N(0, 0.1^2), biases N(0, 0.05^2), so the stream's numbers stay
in range.
"""

from __future__ import annotations

import numpy as np
import torch

from live2diff_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from live2diff_tpu_torch.models.vae import TinyAutoencoder

TINY_OVERRIDES = dict(
    block_out_channels=(8, 16, 16, 16), attention_head_dim=2,
    cross_attention_dim=12, norm_num_groups=4, motion_num_attention_heads=2,
)
RANK = 4

# DreamBooth (LDM) keys -> the diffusers keys they land on, in the tiny UNet
LDM_UNET = {
    "model.diffusion_model.input_blocks.0.0.weight": "conv_in.weight",
    "model.diffusion_model.time_embed.0.weight": "time_embedding.linear_1.weight",
    "model.diffusion_model.out.2.bias": "conv_out.bias",
    "model.diffusion_model.input_blocks.1.0.in_layers.0.weight":
        "down_blocks.0.resnets.0.norm1.weight",
    "model.diffusion_model.input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight":
        "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight",
    "model.diffusion_model.middle_block.1.proj_in.weight": "mid_block.attentions.0.proj_in.weight",
    "model.diffusion_model.output_blocks.5.0.in_layers.2.weight":
        "up_blocks.1.resnets.2.conv1.weight",
    "model.diffusion_model.output_blocks.2.1.conv.weight": "up_blocks.0.upsamplers.0.conv.weight",
}


def save_file(sd: dict, path: str) -> None:
    """A ``.safetensors`` file through the safetensors package (imported
    here: a host without it writes torch pickles instead), else
    ``torch.save``."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import save_file as save_safetensors

        save_safetensors(sd, path)
    else:
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)


def module_shapes(make):
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in make().state_dict().items()}


def draw(name: str, shape, rs: np.random.RandomState) -> np.ndarray:
    if name.endswith("weight") and len(shape) >= 2:
        arr = rs.randn(*shape) / np.sqrt(int(np.prod(shape[1:])))
    elif name.endswith("weight") and "norm" in name:
        arr = 1.0 + 0.1 * rs.randn(*shape)
    else:
        arr = 0.05 * rs.randn(*shape)
    return arr.astype(np.float32)


def _lora(up_shape, down_shape, rs):
    return (0.1 * rs.randn(*up_shape)).astype(np.float32), \
        (0.1 * rs.randn(*down_shape)).astype(np.float32)


def write_checkpoints(root, unet_overrides=TINY_OVERRIDES, seed: int = 0,
                      safetensors: bool = True) -> dict:
    """Write the set under ``root`` (a pathlib.Path); returns a config dict
    that names every file (``pretrained_model_path``, ``motion_module_path``,
    ``taesd_path``, the DreamBooth, the style LoRA in ``lora_list`` at 0.5,
    ``lcm_lora_path``) and the files' paths under ``"paths"``. Without
    ``safetensors`` the ``.safetensors`` files are torch pickles (``.bin``,
    ``.pth``) instead."""
    ext = ".safetensors" if safetensors else ".pth"
    rs = np.random.RandomState(seed)
    shapes = module_shapes(lambda: UNet3DConditionModel(UNetConfig(**unet_overrides)))
    unet = {k: draw(k, s, rs) for k, s in shapes.items()}
    base = root / "sd15"
    (base / "unet").mkdir(parents=True)
    save_file({k: v for k, v in unet.items() if ".motion_modules." not in k},
              str(base / "unet" / ("diffusion_pytorch_model" + (ext if safetensors
                                                                  else ".bin"))))

    motion = {f"module.{k}": torch.from_numpy(v) for k, v in unet.items()
              if ".motion_modules." in k}
    for k in list(motion):
        if k.endswith("attention_blocks.0.to_q.weight"):
            stem = k[: -len("to_q.weight")]
            motion[stem + "pos_encoder.pe"] = torch.zeros(1, 24, 8)
    motion["module.down_blocks.0.motion_modules.0.grid"] = torch.zeros(2, 2)
    paths = {"motion": str(root / "motion.ckpt")}
    torch.save({"state_dict": motion, "epoch": 3}, paths["motion"])

    ldm = {k: draw(v, shapes[v], rs) for k, v in LDM_UNET.items()}
    ldm["first_stage_model.encoder.conv_in.weight"] = draw("w.weight", (8, 3, 3, 3), rs)
    ldm["cond_stage_model.transformer.text_model.final_layer_norm.weight"] = np.ones(
        12, np.float32)
    paths["dreambooth"] = str(root / ("dreambooth" + ext))
    save_file(ldm, paths["dreambooth"])

    c0, c1 = unet_overrides["block_out_channels"][:2]
    cross = unet_overrides["cross_attention_dim"]
    style = {}
    up, down = _lora((c0, RANK, 1, 1), (RANK, 4, 3, 3), rs)  # 3x3 conv
    style.update({"lora_unet_conv_in.lora_up.weight": up,
                  "lora_unet_conv_in.lora_down.weight": down,
                  "lora_unet_conv_in.alpha": np.asarray(2.0, np.float32)})
    key = "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn2_to_k"
    up, down = _lora((c0, RANK), (RANK, cross), rs)  # linear
    style.update({f"{key}.lora_up.weight": up, f"{key}.lora_down.weight": down,
                  f"{key}.alpha": np.asarray(3.0, np.float32)})
    key = "lora_unet_mid_block_attentions_0_transformer_blocks_0_ff_net_0_proj"
    c3 = unet_overrides["block_out_channels"][-1]
    up, down = _lora((c3 * 8, RANK), (RANK, c3), rs)  # linear, GEGLU's doubled width
    style.update({f"{key}.lora_up.weight": up, f"{key}.lora_down.weight": down})
    paths["style_lora"] = str(root / ("style-lora" + ext))
    save_file(style, paths["style_lora"])

    lcm = {}
    key = "unet.up_blocks.1.attentions.0.transformer_blocks.0.ff.net.2"
    up, down = _lora((c1, RANK), (RANK, c1 * 4), rs)
    lcm.update({f"{key}.lora_B.weight": up, f"{key}.lora_A.weight": down})
    key = "down_blocks.1.attentions.1.transformer_blocks.0.attn1.to_out.0.base_layer"
    up, down = _lora((c1, RANK), (RANK, c1), rs)
    lcm.update({f"{key}.lora_B.weight": up, f"{key}.lora_A.weight": down})
    key = "unet.mid_block.attentions.0.transformer_blocks.0.attn1.to_v.lora_linear_layer"
    up, down = _lora((c3, RANK), (RANK, c3), rs)
    lcm.update({f"{key}.up.weight": up, f"{key}.down.weight": down})
    paths["lcm_lora"] = str(root / ("lcm-lora" + ext))
    save_file(lcm, paths["lcm_lora"])

    paths["taesd"] = str(root / ("taesd" + ext))
    save_file({k: draw(k, s, rs) for k, s in module_shapes(TinyAutoencoder).items()},
              paths["taesd"])
    return {
        "pretrained_model_path": str(base),
        "motion_module_path": paths["motion"],
        "taesd_path": paths["taesd"],
        "lcm_lora_path": paths["lcm_lora"],
        "num_inference_steps": 50,
        "t_index_list": [30, 40],
        "third_party_dict": {
            "dreambooth": paths["dreambooth"],
            "lora_list": [{"lora": paths["style_lora"], "lora_alpha": 0.5}],
        },
        "paths": paths,
    }


def config_without_paths(cfg: dict) -> dict:
    return {k: v for k, v in cfg.items() if k != "paths"}
