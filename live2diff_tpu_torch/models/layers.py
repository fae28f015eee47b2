"""Shared building blocks: time embeddings, positional encodings, feed-forward, norms.

Port of ``live2diff_tpu/models/layers.py``. Activations keep the JAX
package's channels-last layout (video ``[B, F, H, W, C]``); norms compute
their statistics in fp32 whatever the compute dtype. Submodule names follow
the diffusers keys (``linear_1``, ``net.0.proj``, ...) so a checkpoint's
state dict maps on by name.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.choices import DEFAULT_KERNELS, KernelChoices
from ..ops.norm import group_norm_act, layer_norm
from ..parallel.tp import row_linear, tp_copy


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal diffusion-timestep features (diffusers ``Timesteps``), fp32."""
    half = dim // 2
    exponent = (
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / (half - freq_shift)
    )
    args = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Two-layer SiLU MLP lifting sinusoidal features to the UNet time channel."""

    def __init__(self, in_channels: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_channels, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


@functools.lru_cache(maxsize=None)
def sinusoidal_table(
    max_len: int, d_model: int, device: torch.device, dtype: torch.dtype
) -> torch.Tensor:
    """AnimateDiff temporal positional-encoding table ``[max_len, d_model]``:
    interleaved sin (even indices) / cos (odd), computed in fp32. Cached per
    (size, device, dtype): it is a constant of every motion-module call."""
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32) * (-math.log(10000.0) / d_model)
    )
    angles = position * div_term[None, :]
    pe = torch.zeros((max_len, d_model), dtype=torch.float32)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles[:, : d_model // 2])
    return pe.to(device=device, dtype=dtype)


class GEGLU(nn.Module):
    """``proj`` to twice the width, then hidden * GELU(gate) with exact GELU.
    Tensor-parallel, ``proj`` holds this rank's slab of both halves
    (``parallel/tp.py``: GEGLU), so the chunks are its share of each."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hidden, gate = self.proj(x).chunk(2, dim=-1)
        return hidden * F.gelu(gate, approximate="none")


class GEGLUFeedForward(nn.Module):
    """GEGLU feed-forward (diffusers ``FeedForward``, activation_fn="geglu");
    ``net.1`` is the dropout slot, empty at inference. A tp block: ``net.0``
    column-parallel, ``net.2`` row-parallel."""

    tp = None  # the tp group once parallel.tp.shard_params shards it

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim)])

    def tp_divides(self, tp: int) -> bool:
        return self.net[2].in_features % tp == 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return row_linear(self.net[0](tp_copy(x, self.tp)), self.net[2], self.tp)


class FusedGroupNorm(nn.Module):
    """GroupNorm over the trailing channel axis of ``[N, ..., C]`` with
    per-N fp32 statistics and an optional fused activation. ``site`` names
    the call site, as in the JAX package; ``kernels`` says whether the
    GroupNorm kernel may run there (``ops/norm.py:gn_route``); the output is
    in the input's dtype.
    Cut to a slab of whole groups (a sharded resnet's ``norm2``), it
    normalises the groups its weight holds."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5,
                 act: str = "none", site: str = "", kernels: KernelChoices = DEFAULT_KERNELS):
        super().__init__()
        self.num_groups, self.eps, self.act, self.site = num_groups, eps, act, site
        self.channels = channels
        self.kernels = kernels
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        y = group_norm_act(
            x.reshape(x.shape[0], -1, c), self.weight, self.bias,
            groups=self.num_groups * self.weight.numel() // self.channels, eps=self.eps,
            act=self.act, site=self.site,
            kernels=self.kernels,
        )
        return y.reshape(x.shape)


class FusedLayerNorm(nn.Module):
    """LayerNorm over the trailing axis with fp32 statistics; ``site`` and
    ``kernels`` as above."""

    def __init__(self, channels: int, eps: float = 1e-5, site: str = "",
                 kernels: KernelChoices = DEFAULT_KERNELS):
        super().__init__()
        self.eps, self.site, self.kernels = eps, site, kernels
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, eps=self.eps, site=self.site,
                          kernels=self.kernels)
