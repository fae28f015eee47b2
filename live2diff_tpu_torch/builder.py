"""Pipeline builder: config -> checkpoints -> modules -> StreamDiffusionDepth.

Port of ``live2diff_tpu/builder.py:build_pipeline``. It resolves the style
config, ingests the checkpoints it names (SD-1.5's ``unet``, ``vae`` and
``text_encoder`` folders, the motion module, a DreamBooth LDM checkpoint,
the LoRA list, the fused LCM-LoRA, TAESD, DPT-hybrid and textual
inversions) and builds the UNet, the codec (TAESD, or SD-1.5's
AutoencoderKL with ``use_tiny_vae=False``), the DPT-hybrid depth model
and, on request, the CLIP text encoder and tokenizer. Every file that
is absent, and every parameter no file supplied, is listed in
``missing_artifacts``; such parameters are drawn as N(0, 0.02^2) from a
``torch.Generator`` seeded by ``seed``, on the device (as
``live2diff_tpu/builder.py`` draws its placeholders). A config that names
no file builds a pipeline of random weights, as the benchmark runs do.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .config import ConfigDict, load_config
from .convert.checkpoint import build_module, vae_state_dict
from .convert.ldm import convert_ldm_checkpoint
from .convert.lora import merge_lora_into_state_dict
from .convert.state_dict import load_state_dict_file
from .convert.textual_inversion import apply_textual_inversion
from .models.midas import DPTConfig, DPTDepthModel
from .models.text_encoder import CLIPTextModelWithFinalNorm
from .models.unet import UNet3DConditionModel, UNetConfig
from .models.vae import AutoencoderKL, TinyAutoencoder, VAEConfig
from .ops.choices import KernelChoices, Sites
from .schedule import LCMSchedule
from .stream.pipeline import StreamConfig, StreamDiffusionDepth
from .utils.tokenizer import CLIPTokenizer

_DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "fp32": torch.float32, "float32": torch.float32}
# the files of an SD checkpoint folder's unet/vae/text_encoder, in the order tried
_BASE_FILES = ("diffusion_pytorch_model.safetensors", "model.safetensors",
               "diffusion_pytorch_model.bin", "pytorch_model.bin")
DEFAULT_LCM_LORA = "models/loras/lcm-lora-sdv1-5.safetensors"
DEFAULT_TAESD = "models/taesd.safetensors"
PROMPT_SHAPE = (1, 77, 768)

StateDict = Dict[str, torch.Tensor]


@dataclasses.dataclass
class BuiltPipeline:
    stream: StreamDiffusionDepth
    unet: UNet3DConditionModel
    vae: Union[TinyAutoencoder, AutoencoderKL]
    schedule: LCMSchedule
    stream_config: StreamConfig
    depth_model: Optional[DPTDepthModel] = None
    text_encoder: Optional[CLIPTextModelWithFinalNorm] = None
    tokenizer: Optional[CLIPTokenizer] = None
    missing_artifacts: tuple = ()
    prompt_template: str = "{}"
    clip_skip: int = 1
    # per-LoRA factors for changing its strength at run time:
    # {path: {"records": [(which, key, up, down, unit)], "fused_alpha": a}}
    lora_runtime: Dict[str, dict] = dataclasses.field(default_factory=dict)
    # the KL VAE's checkpoint weights (base folder and DreamBooth), which
    # use_tiny_vae=False loads; TAESD does not use them
    vae_sd: StateDict = dataclasses.field(default_factory=dict)
    # wall seconds of the ingest: "read" (files), "lora" (merges), "load"
    # (module builds: copies, casts and placeholder draws)
    ingest_s: Dict[str, float] = dataclasses.field(default_factory=dict)


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


def _isfile(path) -> bool:
    return bool(path) and os.path.isfile(str(path))


def _ingest(cfg, missing: List[str], use_lcm_lora: bool, lcm_lora_path, lora_dict, timing):
    """Read the UNet, text-encoder and VAE weights the config names and
    merge its LoRAs into them: (unet_sd, text_sd, vae_sd, lora_runtime),
    in checkpoint names, as ``live2diff_tpu/builder.py:254-324`` does."""
    t0 = time.perf_counter()
    unet_sd: StateDict = {}
    text_sd: StateDict = {}
    vae_sd: StateDict = {}
    base_path = cfg.get("pretrained_model_path")
    if base_path and os.path.isdir(base_path):
        for sub, target in (("unet", unet_sd), ("vae", vae_sd), ("text_encoder", text_sd)):
            path = next((p for p in (os.path.join(base_path, sub, f) for f in _BASE_FILES)
                         if os.path.isfile(p)), None)
            if path is None:
                missing.append(f"{base_path}/{sub}")
            else:
                target.update(load_state_dict_file(path))
    else:
        missing.append(str(base_path))

    mm_path = cfg.get("motion_module_path")
    if _isfile(mm_path):
        # DataParallel "module." prefixes go; optical-flow "grid" buffers are
        # dropped (as pipeline_animatediff_depth.py does in the original)
        unet_sd.update({k.removeprefix("module."): v
                        for k, v in load_state_dict_file(mm_path).items()
                        if "grid" not in k.split(".")[-1]})
    else:
        missing.append(str(mm_path))

    tp = cfg.get("third_party_dict", {}) or {}
    db_path = tp.get("dreambooth")
    if _isfile(db_path):
        db_unet, db_vae, db_clip = convert_ldm_checkpoint(load_state_dict_file(db_path))
        unet_sd.update(db_unet)
        vae_sd.update(db_vae)
        text_sd.update(db_clip)
    elif db_path:
        missing.append(str(db_path))

    loras = list(tp.get("lora_list", []) or [])
    loras += [{"lora": k, "lora_alpha": v} for k, v in (lora_dict or {}).items()]
    # the LCM-LoRA is fused by default: without it a 2-step LCM denoise of a
    # plain SD-1.5 UNet is noise
    if use_lcm_lora:
        loras.append({"lora": str(lcm_lora_path or cfg.get("lcm_lora_path")
                                  or DEFAULT_LCM_LORA), "lora_alpha": 1.0})
    timing["read"] = time.perf_counter() - t0
    merge_s = 0.0
    lora_runtime: Dict[str, dict] = {}
    for entry in loras:
        path, alpha = entry.get("lora"), entry.get("lora_alpha", 1.0)
        if not _isfile(path):
            missing.append(str(path))
            continue
        t0 = time.perf_counter()
        lora_sd = load_state_dict_file(str(path))
        timing["read"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        records: list = []
        merge_lora_into_state_dict(unet_sd, text_sd, lora_sd, lora_alpha=alpha,
                                   collect=records)
        lora_runtime[str(path)] = {"records": records, "fused_alpha": alpha}
        merge_s += time.perf_counter() - t0
    timing["lora"] = merge_s
    return unet_sd, text_sd, vae_sd, lora_runtime


def _file_state_dict(path, missing: List[str], timing) -> Optional[StateDict]:
    """The state dict of ``path``, or None (and ``path`` reported missing)."""
    if not _isfile(path):
        missing.append(str(path))
        return None
    t0 = time.perf_counter()
    sd = load_state_dict_file(str(path))
    timing["read"] += time.perf_counter() - t0
    return sd


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
    use_depth: bool = True,
    use_text_encoder: bool = False,
    do_add_noise: bool = True,
    use_lcm_lora: bool = True,
    lcm_lora_path: Optional[str] = None,
    lora_dict: Optional[Dict[str, float]] = None,
    unet_overrides: Optional[Dict] = None,
    param_dtype: Optional[torch.dtype] = None,
    flash_variant: str = "dmajor",
    gn_kernel_sites: Sites = frozenset(),
    ln_kernel_sites: Sites = frozenset({"vit"}),
) -> BuiltPipeline:
    """Build the streaming pipeline from a reference-style config dict or YAML.

    ``kv_cache_dtype`` is ``"int8"`` (the served default), ``"bf16"`` or a
    torch dtype; it defaults to ``dtype``. ``use_depth`` adds the full
    DPT-hybrid depth model (``DPTConfig()``), ``use_text_encoder`` the CLIP
    text encoder (``CLIPTextConfig()``) and tokenizer. ``lora_dict``
    ({path: strength}) adds LoRAs after the config's ``lora_list``; the
    LCM-LoRA (``lcm_lora_path``, else the config's, else
    ``models/loras/lcm-lora-sdv1-5.safetensors``) is fused last unless
    ``use_lcm_lora=False``. ``use_tiny_vae=False`` builds SD-1.5's
    ``AutoencoderKL`` (from the base ``vae/`` folder and the DreamBooth
    checkpoint's VAE part, latents scaled by 0.18215) in place of TAESD.
    ``param_dtype`` (default ``dtype``) is the dtype every module stores
    its parameters in, ``dtype`` the one it computes in, as in the JAX
    builder: a linear or conv layer casts its weight and bias to ``dtype``
    at use, a GroupNorm or LayerNorm applies its scale and bias as stored
    (the norm kernels take them cast to ``dtype``). No entry point passes
    it. Runs on the card unless ``device`` says otherwise.

    The last three arguments are the JAX package's kernel knobs, made per
    pipeline (``ops/choices.py:KernelChoices``); their defaults are the JAX
    defaults:

    * ``flash_variant`` (``LIVE2DIFF_FLASH``): ``"dmajor"``, ``"smajor"`` or
      ``"int8"``, the flash kernel of the spatial self-attentions at
      S >= 1024. bench.py's ``--spatial-qk int8`` is ``"int8"`` and its
      default ``--spatial-qk bf16`` is ``"dmajor"`` (``bench.py:218``).
    * ``gn_kernel_sites`` (``LIVE2DIFF_GN_TAGS``): the GroupNorm sites
      (``resnet``, ``attn_in``, ``motion_in``, ``midas``) that launch the
      GroupNorm kernel, ``"all"`` or ``"none"``; none by default.
    * ``ln_kernel_sites`` (``LIVE2DIFF_LN_TAGS``): the LayerNorm sites
      (``spatial``, ``temporal``, ``vit``) that launch the LayerNorm kernel;
      ``vit`` by default.
    """
    param_dtype = param_dtype or dtype
    device = resolve_device(device)
    kernels = KernelChoices(flash_variant, gn_kernel_sites, ln_kernel_sites)
    cfg = load_config(config) if isinstance(config, str) else ConfigDict.wrap(config)
    missing: List[str] = []

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
        # TAESD takes and gives scaled latents; the KL codec SD-1.5's own
        height=height, width=width, vae_scaling=1.0 if use_tiny_vae else 0.18215,
        do_add_noise=do_add_noise,
        cache_dtype=kv_cache_dtype or dtype, output_uint8=output_uint8,
    )

    timing: Dict[str, float] = {}
    unet_sd, text_sd, vae_sd, lora_runtime = _ingest(
        cfg, missing, use_lcm_lora, lcm_lora_path, lora_dict, timing)
    t0, read_before = time.perf_counter(), timing["read"]
    generator = torch.Generator(device=device).manual_seed(seed)
    unet = build_module(lambda: UNet3DConditionModel(unet_cfg, kernels), device, param_dtype,
                        generator, unet_sd or None, missing)
    del unet_sd
    if use_tiny_vae:
        taesd_sd = _file_state_dict(cfg.get("taesd_path", DEFAULT_TAESD), missing, timing)
        vae = build_module(TinyAutoencoder, device, param_dtype, generator, taesd_sd, missing)
    else:
        # SD-1.5's own codec at its own widths, whatever the UNet's overrides
        vae = build_module(lambda: AutoencoderKL(VAEConfig()), device, param_dtype, generator,
                           vae_state_dict(vae_sd) if vae_sd else None, missing)
    depth_model = None
    if use_depth:
        dpt_sd = _file_state_dict(cfg.get("depth_model_path"), missing, timing)
        depth_model = build_module(lambda: DPTDepthModel(DPTConfig(), kernels), device,
                                   param_dtype, generator, dpt_sd, missing)

    text_encoder = tokenizer = None
    tp = cfg.get("third_party_dict", {}) or {}
    base_path = cfg.get("pretrained_model_path")
    if use_text_encoder:
        # LDM checkpoints of older transformers lack the "text_model." level
        text_sd = {k if k.startswith("text_model.") else f"text_model.{k}": v
                   for k, v in text_sd.items()}
        text_encoder = build_module(
            lambda: CLIPTextModelWithFinalNorm(compute_dtype=dtype), device, param_dtype,
            generator, text_sd or None, missing)
        if base_path and os.path.isdir(os.path.join(str(base_path), "tokenizer")):
            tokenizer = CLIPTokenizer.from_pretrained(str(base_path))
        else:
            tokenizer = CLIPTokenizer.tiny(model_max_length=77)
            missing.append(f"{base_path}/tokenizer")
        # textual inversions, one file a token; the table grows, so the
        # embedding is rebuilt at the new vocabulary size
        embedding = text_encoder.text_model.embeddings.token_embedding
        table = embedding.weight
        for token, ti_path in (tp.get("text_embedding_dict", {}) or {}).items():
            ti_sd = _file_state_dict(ti_path, missing, timing)
            if ti_sd is not None:
                tokenizer, table = apply_textual_inversion(tokenizer, table, ti_sd, token)
        if table.shape[0] != text_encoder.config.vocab_size:
            grown = torch.nn.Embedding(*table.shape, device=device, dtype=param_dtype)
            grown.weight.data.copy_(table)
            text_encoder.text_model.embeddings.token_embedding = grown.requires_grad_(False)
            text_encoder.config = dataclasses.replace(text_encoder.config,
                                                      vocab_size=table.shape[0])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # the module builds, less the files read among them
    timing["load"] = time.perf_counter() - t0 - (timing["read"] - read_before)

    stream = StreamDiffusionDepth(unet, vae, schedule, scfg, device, dtype, depth_model)
    return BuiltPipeline(
        stream=stream, unet=unet, vae=vae, schedule=schedule, stream_config=scfg,
        depth_model=depth_model, text_encoder=text_encoder, tokenizer=tokenizer,
        missing_artifacts=tuple(missing),
        prompt_template=cfg.get("prompt_template", cfg.get("prompt", "{}")),
        clip_skip=tp.get("clip_skip", 1),
        lora_runtime=lora_runtime, vae_sd=vae_sd, ingest_s=timing,
    )


def stand_in_prompt_embedding(prompt: str) -> np.ndarray:
    """The ``[1, 77, 768]`` fp32 embedding of a pipeline without a text
    encoder: normal draws seeded by the prompt's SHA-256, so one prompt
    gives one embedding in every process."""
    seed = int.from_bytes(hashlib.sha256(prompt.encode("utf-8")).digest()[:4], "little")
    return np.random.RandomState(seed % 2**31).randn(*PROMPT_SHAPE).astype(np.float32)


def encode_prompt_for_pipeline(built: BuiltPipeline, prompt: str) -> torch.Tensor:
    """Tokenize and CLIP-encode ``prompt`` with the pipeline's clip_skip:
    ``[1, 77, 768]`` fp32 on the pipeline's device."""
    device = built.stream.device
    if built.text_encoder is None:
        return torch.from_numpy(stand_in_prompt_embedding(prompt)).to(device)
    ids = torch.from_numpy(built.tokenizer([prompt]).astype(np.int64)).to(device)
    with torch.no_grad():
        return built.text_encoder(ids, clip_skip=built.clip_skip).float()
