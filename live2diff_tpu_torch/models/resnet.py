"""Framewise ("inflated") conv blocks for the 3D UNet, channels-last.

Port of ``live2diff_tpu/models/resnet.py``. Video activations are
``[B, F, H, W, C]``; every "3D" op is a 2D op applied framewise, the frame
axis folded into the batch. The convolutions are ``F.conv2d`` on a
channels-last view (the JAX package leaves them to XLA too); module and
parameter names follow the diffusers UNet keys.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.choices import DEFAULT_KERNELS, KernelChoices
from ..parallel.tp import tp_copy, tp_reduce
from .layers import FusedGroupNorm


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """Apply a Conv2d to ``[N, H, W, C]`` through a channels-last NCHW view."""
    out = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, conv.stride, conv.padding)
    return out.permute(0, 2, 3, 1)


class InflatedConv(nn.Conv2d):
    """2D conv applied framewise over ``[B, F, H, W, C]``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, h, w, c = x.shape
        out = conv_nhwc(x.reshape(b * f, h, w, c), self)
        return out.reshape(b, f, *out.shape[1:])

    def partial_fp32(self, x: torch.Tensor) -> torch.Tensor:
        """The conv without its bias, as an fp32 tensor: a row-parallel
        partial. Low-precision operands are upcast and convolved with TF32
        allowed: a bf16 value is exact in TF32, so the products are the bf16
        conv's, with an fp32 output."""
        b, f, h, w, c = x.shape
        x = x.reshape(b * f, h, w, c).permute(0, 3, 1, 2)
        if x.dtype == torch.float32:
            out = F.conv2d(x, self.weight, None, self.stride, self.padding)
        else:
            with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                            allow_tf32=True):
                out = F.conv2d(x.float(), self.weight.float(), None, self.stride, self.padding)
        return out.permute(0, 2, 3, 1).reshape(b, f, *out.shape[2:], -1)


class InflatedGroupNorm(FusedGroupNorm):
    """GroupNorm with per-frame statistics over ``[B, F, H, W, C]``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f = x.shape[:2]
        return super().forward(x.reshape(b * f, *x.shape[2:])).reshape(x.shape)


class ResnetBlock3D(nn.Module):
    """norm1 -> silu -> conv1 -> (+ time proj) -> norm2 -> silu -> conv2 -> + skip.

    A tp block (``parallel/tp.py``): sharded, ``conv1`` and ``time_emb_proj``
    give this rank's output channels, ``norm2`` normalises their groups and
    ``conv2`` takes them as its input slab; its partial sums meet in one
    all-reduce, then its bias."""

    tp = None  # the tp group once parallel.tp.shard_params shards it

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 groups: int = 32, eps: float = 1e-6, kernels: KernelChoices = DEFAULT_KERNELS):
        super().__init__()
        self.norm1 = InflatedGroupNorm(groups, in_channels, eps, act="silu", site="resnet",
                                       kernels=kernels)
        self.conv1 = InflatedConv(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = InflatedGroupNorm(groups, out_channels, eps, act="silu", site="resnet",
                                       kernels=kernels)
        self.conv2 = InflatedConv(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (
            InflatedConv(in_channels, out_channels, 1) if in_channels != out_channels else None
        )

    def tp_divides(self, tp: int) -> bool:
        return self.conv1.out_channels % tp == 0 and self.norm2.num_groups % tp == 0

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor]) -> torch.Tensor:
        h = self.conv1(tp_copy(self.norm1(x), self.tp))
        if temb is not None:
            # temb is per batch row: [B, C] -> broadcast over F, H, W
            h = h + self.time_emb_proj(F.silu(tp_copy(temb, self.tp)))[:, None, None, None, :]
        if self.tp is None:
            h = self.conv2(self.norm2(h))
        else:
            # the partials summed in fp32 and rounded once, then the bias:
            # the unsharded conv rounds its accumulator, and torch adds a
            # cuDNN conv's bias after it (rounding again)
            h = tp_reduce(self.conv2.partial_fp32(self.norm2(h)), self.tp).to(h.dtype)
            h = h + self.conv2.bias
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample3D(nn.Module):
    """Strided-conv 2x spatial downsample, framewise."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = InflatedConv(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample3D(nn.Module):
    """Nearest-neighbour upsample to ``output_size`` (2x by default) + conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = InflatedConv(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor, output_size: Optional[Tuple[int, int]] = None):
        b, f, h, w, c = x.shape
        th, tw = output_size if output_size is not None else (h * 2, w * 2)
        if th % h == 0 and tw % w == 0:
            x = x.repeat_interleave(th // h, dim=2).repeat_interleave(tw // w, dim=3)
        else:
            # odd skip dims: legacy-nearest indexing src = floor(dst * in / out)
            rows = torch.floor(torch.arange(th, device=x.device) * (h / th)).long()
            cols = torch.floor(torch.arange(tw, device=x.device) * (w / tw)).long()
            x = x[:, :, rows][:, :, :, cols]
        return self.conv(x)


class MappingNetwork(nn.Module):
    """ControlNet-style depth-conditioning encoder (stride-1 convs, SiLU),
    ending in a conv that a checkpoint initialises to zero."""

    def __init__(self, embedding_channels: int,
                 block_out_channels: Sequence[int] = (16, 32, 96, 256),
                 conditioning_channels: int = 4):
        super().__init__()
        self.conv_in = InflatedConv(conditioning_channels, block_out_channels[0], 3, padding=1)
        blocks = []
        for i in range(len(block_out_channels) - 1):
            ch_in, ch_out = block_out_channels[i], block_out_channels[i + 1]
            blocks.append(InflatedConv(ch_in, ch_in, 3, padding=1))
            blocks.append(InflatedConv(ch_in, ch_out, 3, padding=1))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = InflatedConv(block_out_channels[-1], embedding_channels, 3, padding=1)

    def forward(self, conditioning: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.conv_in(conditioning))
        for block in self.blocks:
            x = F.silu(block(x))
        return self.conv_out(x)
