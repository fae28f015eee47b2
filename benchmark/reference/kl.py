"""The plain reference of the ``sd15-live2diff-demo-kl`` configuration: the
stream's UNet and DPT-hybrid of ``models.py``, with SD-1.5's KL autoencoder
(diffusers ``AutoencoderKL``, runwayml/stable-diffusion-v1-5 ``vae/``) as
its codec, in fp32 PyTorch.

The codec is written from the published description, on ``models.py``'s
plain ops (``linear``, ``conv``, ``group_norm``, ``attention``), so that
``models.set_low`` (the control) reaches every product. Parameter names
are the diffusers ``vae/`` keys, which the program uses too
(``encoder.down_blocks.0.resnets.0.norm1``, ``encoder.mid_block.
attentions.0.to_q``, ``quant_conv``, ...):

* encoder: ``conv_in``; per level ``layers_per_block`` resnets (GroupNorm,
  SiLU, 3x3 conv, twice, a 1x1 shortcut where the width changes), then,
  but at the last level, a (0, 1) zero pad of H and W and a stride-2 3x3
  conv; the mid block (resnet, one-head self-attention with a GroupNorm in
  front and the input added back, resnet); GroupNorm, SiLU, ``conv_out``
  to the posterior's mean and log-variance; ``quant_conv``.
* decoder: ``post_quant_conv``; ``conv_in``; the mid block; per level of
  the reversed widths ``layers_per_block + 1`` resnets, then, but at the
  last level, nearest 2x and a 3x3 conv; GroupNorm, SiLU, ``conv_out``.

The stream reaches it as ``encode(images) -> mean * scaling_factor`` and
``decode(latents) -> decoder(post_quant_conv(latents / scaling_factor))``.

Departures from the published description, each as the measured program
has it: ``encode`` takes the posterior's mean and draws no sample (the
configuration's ``assumed`` says what a sample would add); the log-variance
half of the moments is computed and dropped. Images are channels last.

It imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import models as base


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, eps: float):
        super().__init__()
        self.norm1 = base.GN(groups, cin, eps)
        self.conv1 = base.Conv(cin, cout, 3, padding=1)
        self.norm2 = base.GN(groups, cout, eps)
        self.conv2 = base.Conv(cout, cout, 3, padding=1)
        self.conv_shortcut = base.Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """One head over the H x W positions, D = C, the input added back."""

    def __init__(self, c: int, groups: int, eps: float):
        super().__init__()
        self.group_norm = base.GN(groups, c, eps)
        self.to_q, self.to_k, self.to_v = base.Lin(c, c), base.Lin(c, c), base.Lin(c, c)
        self.to_out = nn.ModuleList([base.Lin(c, c)])

    def forward(self, x):
        n, h, w, c = x.shape
        t = self.group_norm(x).reshape(n, h * w, 1, c)
        o = base.attention(self.to_q(t), self.to_k(t), self.to_v(t))
        return self.to_out[0](o.reshape(n, h, w, c)) + x


class Resampler(nn.Module):
    def __init__(self, c: int, stride: int):
        super().__init__()
        self.conv = base.Conv(c, c, 3, stride=stride, padding=0 if stride == 2 else 1)


def mid_block(c: int, groups: int, eps: float) -> nn.Module:
    mid = base._Block()
    mid.resnets.extend([ResnetBlock(c, c, groups, eps), ResnetBlock(c, c, groups, eps)])
    mid.attentions.append(Attention(c, groups, eps))
    return mid


def run_mid(mid: nn.Module, x):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        ch, g, eps = v["block_out_channels"], v["norm_num_groups"], v["norm_eps"]
        self.conv_in = base.Conv(v["in_channels"], ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cur = ch[0]
        for i, c in enumerate(ch):
            blk = base._Block()
            for _ in range(v["layers_per_block"]):
                blk.resnets.append(ResnetBlock(cur, c, g, eps))
                cur = c
            if i < len(ch) - 1:
                blk.downsamplers.append(Resampler(c, 2))
            self.down_blocks.append(blk)
        self.mid_block = mid_block(ch[-1], g, eps)
        self.conv_norm_out = base.GN(g, ch[-1], eps)
        self.conv_out = base.Conv(ch[-1], 2 * v["latent_channels"], 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for resnet in blk.resnets:
                x = resnet(x)
            for down in blk.downsamplers:
                x = down.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))  # W right, H bottom
        x = run_mid(self.mid_block, x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        g, eps = v["norm_num_groups"], v["norm_eps"]
        rev = list(reversed(v["block_out_channels"]))
        self.conv_in = base.Conv(v["latent_channels"], rev[0], 3, padding=1)
        self.mid_block = mid_block(rev[0], g, eps)
        self.up_blocks = nn.ModuleList()
        cur = rev[0]
        for i, c in enumerate(rev):
            blk = base._Block()
            for _ in range(v["layers_per_block"] + 1):
                blk.resnets.append(ResnetBlock(cur, c, g, eps))
                cur = c
            if i < len(rev) - 1:
                blk.upsamplers.append(Resampler(c, 1))
            self.up_blocks.append(blk)
        self.conv_norm_out = base.GN(g, rev[-1], eps)
        self.conv_out = base.Conv(rev[-1], v["out_channels"], 3, padding=1)

    def forward(self, z):
        x = run_mid(self.mid_block, self.conv_in(z))
        for blk in self.up_blocks:
            for resnet in blk.resnets:
                x = resnet(x)
            for up in blk.upsamplers:
                x = up.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        lat = v["latent_channels"]
        self.latent_channels, self.scaling = lat, v["scaling_factor"]
        self.encoder = Encoder(v)
        self.decoder = Decoder(v)
        self.quant_conv = base.Conv(2 * lat, 2 * lat, 1)
        self.post_quant_conv = base.Conv(lat, lat, 1)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Images ``[N, H, W, 3]`` in [-1, 1] -> the posterior's mean, scaled,
        ``[N, H/8, W/8, latent]``."""
        moments = self.quant_conv(self.encoder(x))
        return moments[..., :self.latent_channels] * self.scaling

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z / self.scaling))


def models(cfg: dict) -> Dict[str, nn.Module]:
    """``models.py``'s UNet and (with depth) DPT-hybrid, and the KL codec."""
    out = {"unet": base.UNet(cfg["unet"]), "vae": AutoencoderKL(cfg["vae"])}
    if cfg["use_depth"]:
        out["depth"] = base.DPT(cfg["dpt"])
    return out


# ---------------------------------------------------------------------------
# work counts (see work.py): products of convs and matrices, two a multiply-add
# ---------------------------------------------------------------------------


def _conv(cin: int, cout: int, k: int, h: int, w: int) -> float:
    return 2.0 * cout * cin * k * k * h * w


def _resnet(cin: int, cout: int, h: int, w: int) -> float:
    f = _conv(cin, cout, 3, h, w) + _conv(cout, cout, 3, h, w)
    return f + (_conv(cin, cout, 1, h, w) if cin != cout else 0.0)


def _attention(c: int, s: int) -> float:
    """The mid block's attention of one image: q, k, v and out projections
    and the two products over S positions."""
    return 4 * 2.0 * s * c * c + 4.0 * s * s * c


def codec_flops(cfg: dict, height: int, width: int, encodes: int, decodes: int) -> float:
    """The encoder on ``encodes`` images and the decoder on ``decodes``
    latents of a ``height`` x ``width`` frame, with the quant convs."""
    v = cfg["vae"]
    ch, per, lat = v["block_out_channels"], v["layers_per_block"], v["latent_channels"]
    h, w = height, width
    enc = _conv(v["in_channels"], ch[0], 3, h, w)
    cur = ch[0]
    for i, c in enumerate(ch):
        for _ in range(per):
            enc += _resnet(cur, c, h, w)
            cur = c
        if i < len(ch) - 1:
            h, w = h // 2, w // 2  # the (0, 1) pad, then VALID at stride 2
            enc += _conv(c, c, 3, h, w)
    enc += 2 * _resnet(cur, cur, h, w) + _attention(cur, h * w)
    enc += _conv(cur, 2 * lat, 3, h, w) + _conv(2 * lat, 2 * lat, 1, h, w)
    rev = list(reversed(ch))
    h, w = height // 2 ** (len(ch) - 1), width // 2 ** (len(ch) - 1)
    dec = _conv(lat, lat, 1, h, w) + _conv(lat, rev[0], 3, h, w)
    dec += 2 * _resnet(rev[0], rev[0], h, w) + _attention(rev[0], h * w)
    cur = rev[0]
    for i, c in enumerate(rev):
        for _ in range(per + 1):
            dec += _resnet(cur, c, h, w)
            cur = c
        if i < len(rev) - 1:
            h, w = 2 * h, 2 * w
            dec += _conv(c, c, 3, h, w)
    dec += _conv(cur, v["out_channels"], 3, h, w)
    return encodes * enc + decodes * dec


def codec_attention_calls(cfg: dict, traffic: dict) -> List[Tuple[float, float]]:
    """(FLOPs, bytes) of each mid-block attention of one call, with its
    projections: the encode's over the frames and depth images of every
    session, then the decode's over one latent a session. Bytes: the input
    and the output, and the q, k, v and out weights, in bf16. No flash
    kernel serves these calls, so ``flash_attention_calls`` leaves them out."""
    v = cfg["vae"]
    c = v["block_out_channels"][-1]
    down = 2 ** (len(v["block_out_channels"]) - 1)
    s = (traffic["height"] // down) * (traffic["width"] // down)
    sessions = traffic["sessions"]
    out = []
    for n in ((2 if cfg["use_depth"] else 1) * sessions, sessions):
        out.append((n * _attention(c, s), 2.0 * (2 * n * s * c + 4 * c * c)))
    return out
