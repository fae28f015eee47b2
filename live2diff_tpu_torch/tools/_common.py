"""What the tools share: bench.py's configuration, the tiny pipeline, the
card's line and seeded inputs."""

from __future__ import annotations

import subprocess
from typing import Sequence, Tuple

import numpy as np
import torch

# bench.py's make_config([30, 40]) with the steps as an argument
NOISE_SCHEDULER = {"num_train_timesteps": 1000, "beta_start": 0.00085, "beta_end": 0.012,
                   "beta_schedule": "linear"}
MOTION = {"num_attention_heads": 8, "temporal_position_encoding_max_len": 24,
          "attention_kwargs": {"window_size": 16, "sink_size": 8}}
# --tiny: 64x64 frames through a narrow UNet whose widths the card's kernels
# take (head dim 16 and up), no depth model; fp32 on the CPU, bf16 on the card
TINY_SIZE = 64
TINY_UNET = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=2, norm_num_groups=8,
                 motion_num_attention_heads=2)
FLASH_VARIANT = {"bf16": "dmajor", "int8": "int8"}  # bench.py's --spatial-qk


def bench_config(steps: Sequence[int] = (30, 40)) -> dict:
    return {"num_inference_steps": 50, "t_index_list": list(steps),
            "noise_scheduler_kwargs": dict(NOISE_SCHEDULER),
            "unet_additional_kwargs": {"cond_mapping": True,
                                       "motion_module_kwargs": dict(MOTION)}}


def tiny_dtype(device: torch.device) -> str:
    return "float32" if device.type == "cpu" else "bfloat16"


def card_line(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or what ran
    instead: a CPU run measures no device."""
    if device.type != "cuda":
        return "cpu (host timings, not a device measurement)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def build_bench_pipeline(device, height: int = 512, width: int = 512,
                         steps: Sequence[int] = (30, 40), kv_cache: str = "int8",
                         spatial_qk: str = "bf16", use_depth: bool = True, tiny: bool = False,
                         seed: int = 0):
    """bench.py's pipeline (TAESD, DPT-hybrid unless ``use_depth`` is off,
    uint8 frames out, random weights from ``seed``), or the tiny one."""
    from ..builder import build_pipeline, resolve_device

    device = resolve_device(device)
    kw = {}
    dtype = torch.bfloat16
    if tiny:
        height = width = TINY_SIZE
        use_depth = False
        kw["unet_overrides"] = TINY_UNET
        dtype = getattr(torch, tiny_dtype(device))
    return build_pipeline(bench_config(steps), height, width, dtype=dtype,
                          kv_cache_dtype=kv_cache, output_uint8=True, seed=seed, device=device,
                          use_depth=use_depth, flash_variant=FLASH_VARIANT[spatial_qk], **kw)


def inputs(stream, frames: int, sessions: int = 1, seed: int = 0
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Seeded inputs on the stream's device: a ``[S, 77, D]`` prompt
    embedding, ``[S, 8, H, W, 3]`` warmup frames in [-1, 1] and ``[N, S, H,
    W, 3]`` uint8 frames (S = ``sessions``)."""
    rng = np.random.RandomState(seed)
    h, w = stream.cfg.height, stream.cfg.width
    dim = stream.unet.config.cross_attention_dim
    prompt = rng.randn(sessions, 77, dim).astype(np.float32)
    warm = rng.rand(sessions, 8, h, w, 3).astype(np.float32) * 2 - 1
    clip = rng.randint(0, 256, (frames, sessions, h, w, 3)).astype(np.uint8)
    return tuple(torch.from_numpy(a).to(stream.device) for a in (prompt, warm, clip))
