"""Image codecs, NHWC: SD-1.5's AutoencoderKL and the tiny distilled TAESD.

Port of ``live2diff_tpu/models/vae.py``. Both codecs map ``[N, H, W, 3]``
frames in [-1, 1] to ``[N, H/8, W/8, 4]`` latents and back.

``AutoencoderKL`` is SD-1.5's own codec, under the diffusers ``vae/`` key
names (``encoder.down_blocks.0.resnets.0.norm1``, ``quant_conv``,
``decoder.mid_block.attentions.0.to_q``, ...), so a diffusers state dict
loads by name. No kernel of the JAX package sits under it: its convs are
``F.conv2d`` (cuDNN on the card) on channels-last views, its GroupNorms
``F.group_norm`` in fp32 with eps 1e-6 cast back to the compute dtype, and
its one-head mid-block attention at D = 512 plain matmuls, with the JAX
module's roundings: logits from a product in the compute dtype, cast to
fp32 and scaled, an fp32 softmax, probabilities cast back.

TAESD's module indices follow the madebyollin/taesd ``nn.Sequential``
numbering (``encoder.0``, ``encoder.1.conv.2``, ..., including the
parameter-free Clamp / ReLU / Upsample slots) so a TAESD state dict loads
by name. Every ``FusedConv3x3`` / ``FusedConv3x3S2`` goes through
``ops.conv.conv3x3``: on the card that is the hand-written kernel (64
stride-1 and 3 stride-2 launches per stream step at 512x512); the 1x1 skips
and the 3-/4-channel end convs stay ``F.conv2d``, as the JAX package leaves
them to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import conv3x3
from .layers import Linear, at_dtype
from .resnet import conv_nhwc

NoiseFn = Callable[[Tuple[int, ...]], torch.Tensor]


# ---------------------------------------------------------------------------
# AutoencoderKL (SD-1.5)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


class VAEGroupNorm(nn.GroupNorm):
    """GroupNorm over ``[N, H, W, C]``, eps 1e-6, computed in fp32 and cast
    to the input's dtype (flax ``nn.GroupNorm(dtype=float32)`` then
    ``astype``)."""

    def __init__(self, groups: int, channels: int):
        super().__init__(groups, channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.group_norm(x.float().permute(0, 3, 1, 2), self.num_groups,
                           self.weight.float(), self.bias.float(), self.eps)
        return out.permute(0, 2, 3, 1).to(x.dtype)


class VAEResnetBlock(nn.Module):
    """GroupNorm -> SiLU -> conv, twice, plus the (1x1-projected) input."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32):
        super().__init__()
        self.norm1 = VAEGroupNorm(groups, in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = VAEGroupNorm(groups, out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv_nhwc(F.silu(self.norm1(x)), self.conv1)
        h = conv_nhwc(F.silu(self.norm2(h)), self.conv2)
        if self.conv_shortcut is not None:
            x = conv_nhwc(x, self.conv_shortcut)
        return x + h


class VAEAttention(nn.Module):
    """One-head self-attention over the spatial positions (the mid block's)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = VAEGroupNorm(groups, channels)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        t = self.group_norm(x).reshape(b, h * w, c)
        q, k, v = self.to_q(t), self.to_k(t), self.to_v(t)
        # logits rounded to the compute dtype, then scaled and normalised in fp32
        logits = torch.matmul(q, k.transpose(1, 2)).float() * (c ** -0.5)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = self.to_out[0](torch.matmul(probs, v))
        return out.reshape(b, h, w, c) + x


class _VAEBlock(nn.Module):
    """A down, mid or up block under the diffusers key names."""

    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()
        self.downsamplers = nn.ModuleList()
        self.upsamplers = nn.ModuleList()


class _Resampler(nn.Module):
    """Holds a resampling conv under the ``...samplers.0.conv`` key."""

    def __init__(self, channels: int, stride: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=stride, padding=0 if stride == 2 else 1)


def _mid_block(ch: int, groups: int) -> _VAEBlock:
    mid = _VAEBlock()
    mid.resnets.extend([VAEResnetBlock(ch, ch, groups), VAEResnetBlock(ch, ch, groups)])
    mid.attentions.append(VAEAttention(ch, groups))
    return mid


def _run_mid(mid: _VAEBlock, x: torch.Tensor) -> torch.Tensor:
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](x)))


class VAEEncoder(nn.Module):
    """[N, H, W, 3] -> [N, H/8, W/8, 2 * latent] (mean and log-variance)."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        cfg, ch, g = config, config.block_out_channels, config.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cur = ch[0]
        for i, out_ch in enumerate(ch):
            blk = _VAEBlock()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(VAEResnetBlock(cur, out_ch, g))
                cur = out_ch
            if i < len(ch) - 1:
                blk.downsamplers.append(_Resampler(out_ch, stride=2))
            self.down_blocks.append(blk)
        self.mid_block = _mid_block(ch[-1], g)
        self.conv_norm_out = VAEGroupNorm(g, ch[-1])
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_nhwc(x, self.conv_in)
        for blk in self.down_blocks:
            for resnet in blk.resnets:
                x = resnet(x)
            for down in blk.downsamplers:
                # pad (0, 1) on H and W, then a stride-2 VALID conv
                x = conv_nhwc(F.pad(x, (0, 0, 0, 1, 0, 1)), down.conv)
        x = _run_mid(self.mid_block, x)
        return conv_nhwc(F.silu(self.conv_norm_out(x)), self.conv_out)


class VAEDecoder(nn.Module):
    """[N, h, w, latent] -> [N, 8h, 8w, 3]."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        cfg, g = config, config.norm_num_groups
        rev = list(reversed(config.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _mid_block(rev[0], g)
        self.up_blocks = nn.ModuleList()
        cur = rev[0]
        for i, out_ch in enumerate(rev):
            blk = _VAEBlock()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(VAEResnetBlock(cur, out_ch, g))
                cur = out_ch
            if i < len(rev) - 1:
                blk.upsamplers.append(_Resampler(out_ch, stride=1))
            self.up_blocks.append(blk)
        self.conv_norm_out = VAEGroupNorm(g, rev[-1])
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = _run_mid(self.mid_block, conv_nhwc(z, self.conv_in))
        for blk in self.up_blocks:
            for resnet in blk.resnets:
                x = resnet(x)
            for up in blk.upsamplers:
                # nearest 2x, then a 3x3 conv
                x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest")
                x = conv_nhwc(x.permute(0, 2, 3, 1), up.conv)
        return conv_nhwc(F.silu(self.conv_norm_out(x)), self.conv_out)


class AutoencoderKL(nn.Module):
    """SD-1.5's KL autoencoder. ``encode`` returns the latent mean; with a
    ``generator`` (or a ``noise`` function, ``shape -> tensor``, the tests'
    replay of the JAX draw) it adds ``exp(0.5 * clip(logvar, -30, 20)) * eps``.
    The stream runtime takes the mean and adds its own noise."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = VAEEncoder(config)
        self.decoder = VAEDecoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[NoiseFn] = None) -> torch.Tensor:
        moments = conv_nhwc(self.encoder(x), self.quant_conv)
        mean, logvar = moments.chunk(2, dim=-1)
        if generator is None and noise is None:
            return mean
        if noise is not None:
            eps = noise(tuple(mean.shape)).to(device=mean.device, dtype=mean.dtype)
        else:
            eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                              dtype=mean.dtype)
        return mean + torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0)) * eps

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(conv_nhwc(z, self.post_quant_conv))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


# ---------------------------------------------------------------------------
# TAESD (tiny autoencoder)
# ---------------------------------------------------------------------------


class FusedConv3x3(nn.Module):
    """3x3 padding-1 conv with optionally fused bias, skip and ReLU;
    parameters as ``nn.Conv2d`` (weight [Cout, Cin, 3, 3], bias [Cout])."""

    def __init__(self, cin: int, cout: int, relu: bool = False, bias: bool = True,
                 stride: int = 1):
        super().__init__()
        self.relu, self.stride = relu, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        nn.init.kaiming_uniform_(self.weight, a=5**0.5)

    def forward(self, x: torch.Tensor, skip: torch.Tensor = None) -> torch.Tensor:
        return conv3x3(x, at_dtype(self.weight, x.dtype), at_dtype(self.bias, x.dtype), skip,
                       self.relu, self.stride)


class FusedConv3x3S2(FusedConv3x3):
    """3x3 stride-2 padding-1 conv, no bias (TAESD encoder downsample)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, relu=False, bias=False, stride=2)


class TinyBlock(nn.Module):
    """conv-relu-conv-relu-conv + skip, then ReLU (the TAESD ``Block``)."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.conv = nn.ModuleList([
            FusedConv3x3(n_in, n_out, relu=True), nn.ReLU(),
            FusedConv3x3(n_out, n_out, relu=True), nn.ReLU(),
            FusedConv3x3(n_out, n_out, relu=True),
        ])
        self.skip = nn.Conv2d(n_in, n_out, 1, bias=False) if n_in != n_out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv[2](self.conv[0](x))
        skip = x if self.skip is None else conv_nhwc(x, self.skip).contiguous()
        return self.conv[4](h, skip=skip)


class TinyEncoder(nn.ModuleList):
    """[N, H, W, 3] -> [N, H/8, W/8, latent]."""

    def __init__(self, latent_channels: int = 4, hidden: int = 64,
                 num_blocks=(1, 3, 3, 3)):
        layers = [FusedConv3x3(3, hidden)]
        for stage, n in enumerate(num_blocks):
            if stage > 0:
                layers.append(FusedConv3x3S2(hidden, hidden))
            layers += [TinyBlock(hidden, hidden) for _ in range(n)]
        layers.append(nn.Conv2d(hidden, latent_channels, 3, padding=1))
        super().__init__(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *layers, last = self  # (slicing a ModuleList subclass rebuilds it)
        for layer in layers:
            x = layer(x)
        return conv_nhwc(x, last)


class TinyDecoder(nn.ModuleList):
    """[N, h, w, latent] -> [N, 8h, 8w, 3]; slot 0 is the tanh(z/3)*3 clamp."""

    def __init__(self, latent_channels: int = 4, hidden: int = 64):
        layers = [nn.Identity(), nn.Conv2d(latent_channels, hidden, 3, padding=1), nn.ReLU()]
        for _ in range(3):
            layers += [TinyBlock(hidden, hidden) for _ in range(3)]
            layers += [nn.Upsample(scale_factor=2),
                       FusedConv3x3(hidden, hidden, bias=False)]
        layers += [TinyBlock(hidden, hidden), nn.Conv2d(hidden, 3, 3, padding=1)]
        super().__init__(layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = torch.tanh(z / 3.0) * 3.0
        x = torch.relu(conv_nhwc(x, self[1])).contiguous()
        for layer in list(self)[3:-1]:
            if isinstance(layer, nn.Upsample):  # nearest 2x on NHWC
                x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            else:
                x = layer(x)
        return conv_nhwc(x, self[-1])


class TinyAutoencoder(nn.Module):
    """TAESD: 4-channel SD-latent codec. Its scaling factor is 1.0: it takes
    and gives SD latents already scaled, like diffusers ``AutoencoderTiny``."""

    def __init__(self, latent_channels: int = 4, hidden: int = 64):
        super().__init__()
        self.encoder = TinyEncoder(latent_channels, hidden)
        self.decoder = TinyDecoder(latent_channels, hidden)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))
