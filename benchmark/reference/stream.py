"""The plain reference of one live stream: warmup, then one step a frame.

Follows the configuration's semantics, not the program's code paths:

* the LCM schedule (diffusers 0.25 ``LCMScheduler``: the linear beta
  schedule, the 50-step distillation grid, c_skip / c_out with sigma_data
  0.5 and timestep scaling 10) at the configuration's ``t_index_list``;
* the stream batch: the new frame enters at the noisiest step, the n - 1
  frames in flight are the other rows, so an output carries the frame that
  entered n - 1 steps earlier;
* the window bookkeeping of the streaming KV cache (sink slots never
  evicted, the rest filled, then recycled by positional index);
* per frame: the depth map (DPT at 384x384, min-max normalised over the
  call's frames), one encode of frame and depth image, noise at the first
  timestep, the UNet over the step rows, the LCM consistency step,
  re-noising of the in-flight rows, and the decode to uint8.

The models come from the configuration's reference module: the file that
its ``"reference"`` key names under this folder, or ``models.py`` (the
UNet, TAESD and the DPT-hybrid) where it names none. The module's
``models(cfg)`` returns ``{"unet", "vae"[, "depth"]}``; the stream reaches
the codec only through ``vae.encode(images) -> latents`` and
``vae.decode(latents) -> images`` (channels last, images in [-1, 1],
latents in the UNet's scale), so a codec keeps its own mean, quant convs
and scaling inside them.

Noise comes from a ``torch.Generator`` seeded as the program's stream is,
drawn in the same shapes and order, so both see the same numbers on one
device.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import models as default_models
from .models import Cache, level_dims, resize


def lcm_schedule(cfg: dict) -> Dict[str, np.ndarray]:
    """Per-step timesteps and scalings of the configuration's schedule."""
    s = cfg["scheduler"]
    betas = np.linspace(s["beta_start"], s["beta_end"], s["num_train_timesteps"],
                        dtype=np.float64)
    if s["beta_schedule"] != "linear":
        raise ValueError(f"beta_schedule {s['beta_schedule']!r}: the reference has 'linear'")
    alphas_cumprod = np.cumprod(1.0 - betas)
    k = s["num_train_timesteps"] // s["original_inference_steps"]
    grid = (np.arange(1, s["original_inference_steps"] + 1) * k - 1)[::-1]
    steps = cfg["num_inference_steps"]
    pick = np.floor(np.linspace(0, len(grid), num=steps, endpoint=False)).astype(np.int64)
    timesteps = grid[pick]
    t = np.array([timesteps[i] for i in cfg["t_index_list"]], dtype=np.int64)
    scaled = t.astype(np.float64) * 10.0
    return dict(
        timesteps=t,
        c_skip=(0.25 / (scaled ** 2 + 0.25)).astype(np.float32),
        c_out=(scaled / np.sqrt(scaled ** 2 + 0.25)).astype(np.float32),
        alpha=np.sqrt(alphas_cumprod[t]).astype(np.float32),
        beta=np.sqrt(1.0 - alphas_cumprod[t]).astype(np.float32),
    )


def init_window(steps: int, window: int, sink: int, device):
    mask = torch.zeros(steps, window, dtype=torch.bool, device=device)
    mask[:, :sink] = True
    mask[0, sink] = True
    pe_idx = torch.arange(window, device=device).repeat(steps, 1)
    update_idx = torch.full((steps,), sink, dtype=torch.long, device=device)
    if steps > 1:
        update_idx[1] = sink + 1
    return mask, pe_idx, update_idx


def advance_window(mask, pe_idx, sink: int):
    """The window state after a frame: while a row has masked slots the
    next write goes to the first unfilled one; once full, the non-sink PEs
    roll by one and the slot holding the largest PE is written next."""
    window = mask.shape[-1]
    full = mask.all(dim=-1, keepdim=True)
    filled = mask.long().sum(dim=-1)
    rolled = torch.cat([pe_idx[:, :sink], torch.roll(pe_idx[:, sink:], 1, dims=-1)], dim=-1)
    pe_idx = torch.where(full, rolled, pe_idx)
    update_idx = torch.where(full[:, 0], torch.argmax(pe_idx, dim=-1), filled)
    unmask = torch.clamp(filled + 1, max=window)
    mask = torch.arange(window, device=mask.device)[None] < unmask[:, None]
    return mask, pe_idx, update_idx


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    return torch.round((img.clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8)


def reference_module(cfg: dict) -> ModuleType:
    """The module that holds the configuration's models: the file that its
    ``"reference"`` key names (a path, or a file name under this folder),
    loaded by path as a member of this package, so that it builds on
    ``models.py``'s plain ops (``from . import models``) and the control's
    ``models.set_low`` reaches its products; ``models.py`` without the key."""
    name = cfg.get("reference")
    if name is None:
        return default_models
    path = Path(name)
    if not path.is_absolute():
        path = Path(__file__).resolve().parent / path
    spec = importlib.util.spec_from_file_location(f"{__package__}.{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build(cfg: dict, device) -> Dict[str, torch.nn.Module]:
    """The configuration's models, fp32, on ``device``, their parameters
    left unset (``{"unet", "vae"[, "depth"]}``): fill them by name."""
    with torch.device("meta"):
        made = reference_module(cfg).models(cfg)
    return {k: m.to_empty(device=device).eval().requires_grad_(False)
            for k, m in made.items()}


def shapes(cfg: dict) -> List[Tuple[str, str, Tuple[int, ...]]]:
    """(model, parameter name, shape) of every parameter, in a fixed order."""
    return [(k, name, tuple(p.shape)) for k, m in build(cfg, "meta").items()
            for name, p in m.named_parameters()]


class RefStream:
    """One stream of the configuration at ``height`` x ``width``."""

    DEPTH_SIZE = 384

    def __init__(self, cfg: dict, models: Dict[str, torch.nn.Module], height: int, width: int,
                 seed: int, device):
        """``models``: ``build``'s, filled."""
        self.cfg = cfg
        self.unet, self.vae, self.depth = models["unet"], models["vae"], models.get("depth")
        self.height, self.width = height, width
        self.device = device
        sched = lcm_schedule(cfg)
        self.n = n = len(sched["timesteps"])

        def col(a):
            return torch.as_tensor(a, device=device)[:, None, None, None]

        self.c_skip, self.c_out = col(sched["c_skip"]), col(sched["c_out"])
        self.alpha, self.beta = col(sched["alpha"]), col(sched["beta"])
        self.timesteps = torch.as_tensor(sched["timesteps"], device=device)
        self.generator = torch.Generator(device=device).manual_seed(seed)
        ucfg = cfg["unet"]
        self.lh, self.lw = height // 8, width // 8
        dims = level_dims(self.lh, self.lw, len(ucfg["block_out_channels"]))
        int8 = cfg["kv_cache_dtype"] == "int8"
        self.caches = [Cache(n, ucfg["window_size"], dims[level][0] * dims[level][1], c, int8,
                             device) for c, level in self.unet.motion_channels()]
        self.window = init_window(n, ucfg["window_size"], ucfg["sink_size"], device)
        self.x_buf = torch.zeros(max(n - 1, 0), self.lh, self.lw, 4, device=device)
        self.d_buf = torch.zeros_like(self.x_buf)
        self.prompt = None

    def _randn(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device)

    def _depth_image(self, frames: torch.Tensor) -> torch.Tensor:
        d = self.depth(resize(frames, self.DEPTH_SIZE, self.DEPTH_SIZE))
        d = (d - d.min()) / (d.max() - d.min() + 1e-6)
        d3 = d[..., None].expand(*d.shape, 3) * 2.0 - 1.0
        return resize(d3, frames.shape[1], frames.shape[2])

    def _encode(self, frames: torch.Tensor):
        """frames [F, H, W, 3] in [-1, 1] -> (x_t at the first step, depth
        latents)."""
        f = frames.shape[0]
        if self.depth is not None:
            frames = torch.cat([frames, self._depth_image(frames)], dim=0)
        lat = self.vae.encode(frames)
        latents = lat[:f]
        depth = lat[f:] if self.depth is not None else torch.zeros_like(latents)
        eps = self._randn((f, self.lh, self.lw, 4))
        return self.alpha[0] * latents + self.beta[0] * eps, depth

    def _decode(self, x0: torch.Tensor) -> torch.Tensor:
        return to_uint8(self.vae.decode(x0))

    @torch.no_grad()
    def prepare(self, warm_uint8: torch.Tensor, prompt: torch.Tensor) -> torch.Tensor:
        """8 warmup frames ``[8, H, W, 3]`` uint8 and the prompt ``[1, L, D]``:
        the warmup denoise, bidirectional over the clip, which fills slots
        0..7 of every step row's cache. Returns the 8 decoded frames."""
        self.prompt = prompt.float().to(self.device)
        frames = warm_uint8.to(self.device).float() / 127.5 - 1.0
        x_t, depth = self._encode(frames)
        sample, x0 = x_t, None
        for i in range(self.n):
            out = self.unet(sample[None], self.timesteps[i:i + 1], self.prompt, depth[None],
                              self.caches, "warmup", None, i)[0]
            x0 = self.c_out[i] * ((sample - self.beta[i] * out) / self.alpha[i]) \
                + self.c_skip[i] * sample
            if i < self.n - 1:
                sample = self.alpha[i + 1] * x0 + self.beta[i + 1] * self._randn(x0.shape)
        return self._decode(x0)

    @torch.no_grad()
    def step(self, frame_uint8: torch.Tensor) -> torch.Tensor:
        """One frame ``[H, W, 3]`` uint8 in, one ``[H, W, 3]`` uint8 out."""
        n = self.n
        frame = frame_uint8.to(self.device).float()[None] / 127.5 - 1.0
        x_new, d_new = self._encode(frame)
        x_t = torch.cat([x_new, self.x_buf])
        depth = torch.cat([d_new, self.d_buf])
        out = self.unet(x_t[:, None], self.timesteps, self.prompt.expand(n, -1, -1),
                          depth[:, None], self.caches, "stream", self.window)[:, 0]
        x0 = self.c_out * ((x_t - self.beta * out) / self.alpha) + self.c_skip * x_t
        mask, pe_idx, _ = self.window
        self.window = advance_window(mask, pe_idx, self.cfg["unet"]["sink_size"])
        if n > 1:
            eps = self._randn((n - 1, self.lh, self.lw, 4))
            self.x_buf = self.alpha[1:] * x0[:-1] + self.beta[1:] * eps
            self.d_buf = depth[:-1]
        return self._decode(x0[-1:])[0]
