"""Camera frames from a traffic file's parameters and the run's seed.

Each session sees a smooth moving scene plus sensor noise: sinusoidal
gratings drifting at their own speeds and a few discs gliding across it,
uint8 ``[H, W, 3]``. Every seed gives the same sizes, counts and work; only
the content differs. The frames are made on the run's device from a
``torch.Generator`` before the window, as a pool the closed loop cycles
through plus the 8 warmup frames, and handed to the entry as host arrays.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import numpy as np
import torch

WARMUP_FRAMES = 8


def seed_for(seed: int, *names) -> int:
    """A 63-bit seed for one named use of the run's ``--seed``."""
    text = ":".join(str(x) for x in (seed, *names)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def _uniform(g: torch.Generator, lo: float, hi: float, shape=(), device="cpu") -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def session_frames(traffic: Dict, seed: int, session: int, device="cpu"):
    """(warmup ``[8, H, W, 3]``, pool ``[P, H, W, 3]``) uint8 numpy of one
    session."""
    h, w = traffic["height"], traffic["width"]
    p = traffic["pattern"]
    count = WARMUP_FRAMES + traffic["pool_frames"]
    g = torch.Generator(device=device).manual_seed(seed_for(seed, "frames", session))
    ys = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    t = torch.arange(count, device=device, dtype=torch.float32)[:, None, None]
    img = torch.zeros(count, h, w, 3, device=device)
    slo, shi = p["speed_px"]
    for _ in range(p["gratings"]):
        angle = _uniform(g, 0, 2 * math.pi, device=device)
        period = _uniform(g, *p["period_px"], device=device)
        speed = _uniform(g, slo, shi, device=device)
        color = _uniform(g, -1, 1, (3,), device=device)
        phase = xs * torch.cos(angle) + ys * torch.sin(angle) - speed * t
        img += torch.sin(2 * math.pi * phase / period)[..., None] * color
    for _ in range(p["discs"]):
        cx, cy = _uniform(g, 0, w, device=device), _uniform(g, 0, h, device=device)
        vx, vy = _uniform(g, -shi, shi, (2,), device=device)
        radius = _uniform(g, *p["disc_radius_px"], device=device)
        color = _uniform(g, -1.5, 1.5, (3,), device=device)
        px = torch.remainder(cx + vx * t, w)
        py = torch.remainder(cy + vy * t, h)
        inside = (xs - px) ** 2 + (ys - py) ** 2 < radius ** 2
        img += inside[..., None] * color
    img = 127.5 + 40.0 * img
    img += p["noise_std"] * torch.randn(img.shape, generator=g, device=device)
    scene = img.round().clamp(0, 255).to(torch.uint8).cpu().numpy()
    return scene[:WARMUP_FRAMES], np.ascontiguousarray(scene[WARMUP_FRAMES:])
