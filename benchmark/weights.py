"""Model weights made from the seed, on the device, by the fan-in rule.

Matrices and conv kernels N(0, 1/fan_in) (fan-in: every axis but the
first), 1-D ``weight`` leaves (norm scales) N(1, 0.1^2), every other leaf
N(0, 0.05^2): a signal then crosses every layer, and the depth head does
not sit at 0 as it does under a flat N(0, 0.02^2) fill. The draws are a
few large ``torch.randn`` calls on one ``torch.Generator`` of the device,
in the served dtype; each leaf is a slice of them, in the order of the
shapes given, so the same seed gives the same tensors on the same device.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

# draws a call: at most this many elements are held at once beside the
# leaves
CHUNK = 1 << 28

Shapes = List[Tuple[str, str, Tuple[int, ...]]]  # (model, leaf name, shape)


def rule(name: str, shape) -> Tuple[float, float]:
    """(mean, std) of a leaf."""
    if len(shape) > 1:
        fan_in = 1
        for s in shape[1:]:
            fan_in *= s
        return 0.0, fan_in ** -0.5
    if name.endswith("weight"):
        return 1.0, 0.1
    return 0.0, 0.05


def _draws(total: int, generator: torch.Generator, dtype, device) -> Iterator[torch.Tensor]:
    left = total
    while left > 0:
        n = min(left, CHUNK)
        yield torch.randn(n, generator=generator, dtype=dtype, device=device)
        left -= n


def fill(shapes: Shapes, seed: int, dtype, device,
         into: Dict[str, Dict[str, torch.Tensor]]) -> None:
    """Each leaf of ``shapes``, made in ``dtype`` on ``device``, copied in
    place into its tensor of ``into`` ({model: {name: tensor}}, such as a
    model's parameters)."""
    generator = torch.Generator(device=device).manual_seed(seed)
    total = sum(torch.Size(s).numel() for _, _, s in shapes)
    draws = _draws(total, generator, dtype, device)
    buf, off = next(draws, None), 0
    for model, name, shape in shapes:
        n = torch.Size(shape).numel()
        parts = []
        while n > 0:
            if off == buf.numel():
                buf, off = next(draws), 0
            take = min(n, buf.numel() - off)
            parts.append(buf[off:off + take])
            off += take
            n -= take
        flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        mean, std = rule(name, shape)
        with torch.no_grad():
            into[model][name].copy_((flat.view(shape) * std + mean).to(dtype))
