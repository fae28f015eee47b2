"""Pipeline builder: config -> models -> random weights -> StreamDiffusionDepth.

Port of the parts of ``live2diff_tpu/builder.py:build_pipeline`` that this
slice covers: the TAESD codec, no depth model, no text encoder. Checkpoint
ingest is a later slice, so every weight is a seeded random normal at
scale 0.02 (as ``live2diff_tpu/builder.py`` draws its placeholders), drawn on the device by a
``torch.Generator``. Prompt embeddings come in as a ``[1, 77, 768]`` tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch
from torch import nn

from .config import ConfigDict, load_config
from .models.unet import UNet3DConditionModel, UNetConfig
from .models.vae import TinyAutoencoder
from .schedule import LCMSchedule
from .stream.pipeline import StreamConfig, StreamDiffusionDepth

_DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "fp32": torch.float32, "float32": torch.float32}


@dataclasses.dataclass
class BuiltPipeline:
    stream: StreamDiffusionDepth
    unet: UNet3DConditionModel
    vae: TinyAutoencoder
    schedule: LCMSchedule
    stream_config: StreamConfig


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The card unless the caller names another device; never a silent
    fall back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "live2diff_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain torch versions on the CPU"
        )
    return device


def random_init_(module: nn.Module, generator: torch.Generator, scale: float = 0.02) -> None:
    """Fill every parameter with N(0, scale^2) from ``generator``, in place
    on the parameter's device."""
    with torch.no_grad():
        for p in module.parameters():
            p.normal_(0.0, scale, generator=generator)


def _materialise(make, device: torch.device, dtype: torch.dtype, generator) -> nn.Module:
    """Build a module without allocating or initialising it on the host,
    then draw its weights on ``device``."""
    with torch.device("meta"):
        module = make()
    module = module.to(dtype=dtype).to_empty(device=device)
    random_init_(module, generator)
    return module.eval().requires_grad_(False)


def build_pipeline(
    config: Union[str, Dict],
    height: int = 512,
    width: int = 512,
    t_index_list=None,
    dtype: torch.dtype = torch.bfloat16,
    kv_cache_dtype=None,
    output_uint8: bool = False,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
    num_inference_steps: Optional[int] = None,
    strength: Optional[float] = None,
    use_tiny_vae: bool = True,
    use_depth: bool = False,
    do_add_noise: bool = True,
    unet_overrides: Optional[Dict] = None,
) -> BuiltPipeline:
    """Build the streaming pipeline from a reference-style config dict or YAML.

    ``kv_cache_dtype`` is ``"int8"`` (the served default), ``"bf16"`` or a
    torch dtype; it defaults to ``dtype``. Runs on the card unless
    ``device`` says otherwise.
    """
    if use_depth:
        raise NotImplementedError(
            "use_depth=True needs the DPT-hybrid depth model (models/midas.py and its "
            "LayerNorm kernel), the next item of ROADMAP.md's port queue"
        )
    if not use_tiny_vae:
        raise NotImplementedError("AutoencoderKL is not ported yet (ROADMAP.md port queue)")
    device = resolve_device(device)
    cfg = load_config(config) if isinstance(config, str) else ConfigDict.wrap(config)

    schedule = LCMSchedule.from_config(
        cfg.get("noise_scheduler_kwargs", {}) or {},
        num_inference_steps=num_inference_steps or cfg.get("num_inference_steps", 50),
        t_index_list=t_index_list or cfg.get("t_index_list"),
        strength=strength if strength is not None else cfg.get("strength"),
    )
    unet_cfg = UNetConfig.from_reference_config(cfg.to_dict(), **(unet_overrides or {}))
    if isinstance(kv_cache_dtype, str):
        kv_cache_dtype = _DTYPES[kv_cache_dtype]
    scfg = StreamConfig(
        height=height, width=width, vae_scaling=1.0, do_add_noise=do_add_noise,
        cache_dtype=kv_cache_dtype or dtype, output_uint8=output_uint8,
    )

    generator = torch.Generator(device=device).manual_seed(seed)
    unet = _materialise(lambda: UNet3DConditionModel(unet_cfg), device, dtype, generator)
    vae = _materialise(TinyAutoencoder, device, dtype, generator)
    stream = StreamDiffusionDepth(unet, vae, schedule, scfg, device, dtype)
    return BuiltPipeline(stream=stream, unet=unet, vae=vae, schedule=schedule,
                         stream_config=scfg)
