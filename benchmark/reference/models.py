"""The plain reference of the Live2Diff stream model, in fp32 PyTorch.

A frozen copy of the measured program's model code (the depth-conditioned
SD-1.5 motion UNet with its streaming temporal attention, TAESD and the
MiDaS DPT-hybrid), written again with plain ops only: ``F.conv2d``,
``F.linear``, an explicit softmax attention and ``F.group_norm`` /
``F.layer_norm``, all in fp32. Module and parameter names are the
checkpoint names the program uses, so one state dict fills both.

It imports nothing of the program. The stream attention is written as the
textbook product over the window, with the positional encodings added to
the cached keys and values, not in the program's factored form.

``set_low(dtype)`` runs every matrix product and convolution on operands
rounded to ``dtype`` (a float8 type, one scale a tensor) and accumulated
in fp32: the control that the comparison must refuse. ``set_low(None)`` is
the reference itself.

Layout: channels last, video ``[B, F, H, W, C]``, as the program's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_LOW: List[Optional[torch.dtype]] = [None]


def set_low(dtype: Optional[torch.dtype]) -> None:
    """Round every product's operands to ``dtype`` (None: fp32 throughout)."""
    _LOW[0] = dtype


def low(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the low precision with one scale (its absmax over the
    type's largest value), back in fp32; ``t`` itself in fp32 mode."""
    dtype = _LOW[0]
    if dtype is None:
        return t
    scale = t.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    return F.linear(low(x), low(w), b)


def conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, stride: int = 1,
         padding: int = 0) -> torch.Tensor:
    """A conv over ``[N, H, W, C]``."""
    y = F.conv2d(low(x.permute(0, 3, 1, 2)), low(w), b, stride, padding)
    return y.permute(0, 2, 3, 1)


# logits a block of the attention may hold at once
_ATTN_BLOCK = 1 << 27


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over ``[N, S, H, D]``, in blocks of rows."""
    n, sq, h, d = q.shape
    sk = k.shape[1]
    rows = max(1, _ATTN_BLOCK // (n * h * sk))
    outs = []
    for i in range(0, sq, rows):
        logits = torch.einsum("nqhd,nkhd->nhqk", low(q[:, i:i + rows]), low(k)) * d ** -0.5
        p = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("nhqk,nkhd->nqhd", low(p), low(v)))
    return torch.cat(outs, dim=1)


def group_norm(x: torch.Tensor, weight, bias, groups: int, eps: float) -> torch.Tensor:
    """GroupNorm of ``[N, ..., C]`` with per-N statistics."""
    n, c = x.shape[0], x.shape[-1]
    y = F.group_norm(x.reshape(n, -1, c).transpose(1, 2), groups, weight, bias, eps)
    return y.transpose(1, 2).reshape(x.shape)


class Lin(nn.Linear):
    def forward(self, x):
        return linear(x, self.weight, self.bias)


class GN(nn.Module):
    def __init__(self, groups: int, channels: int, eps: float):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.groups, self.eps)


class LN(nn.Module):
    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


class Conv(nn.Conv2d):
    """A conv over ``[N, H, W, C]``, or framewise over ``[B, F, H, W, C]``."""

    def forward(self, x):
        lead = x.shape[:-3]
        y = conv(x.reshape(-1, *x.shape[-3:]), self.weight, self.bias, self.stride[0],
                 self.padding[0])
        return y.reshape(*lead, *y.shape[1:])


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def pe_table(max_len: int, dim: int, device) -> torch.Tensor:
    """Interleaved sin (even channels) / cos (odd) positional encodings."""
    pos = torch.arange(max_len, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32) * (-math.log(10000.0) / dim))
    pe = torch.zeros(max_len, dim)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)[:, : dim // 2]
    return pe.to(device)


class TimeEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1, self.linear_2 = Lin(cin, dim), Lin(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class Resnet(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int, groups: int, eps: float):
        super().__init__()
        self.norm1 = GN(groups, cin, eps)
        self.conv1 = Conv(cin, cout, 3, padding=1)
        self.time_emb_proj = Lin(temb, cout)
        self.norm2 = GN(groups, cout, eps)
        self.conv2 = Conv(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x, emb):  # x [B, F, H, W, C] with per-frame statistics
        b, f = x.shape[:2]

        def norm(m, t):
            return F.silu(m(t.reshape(b * f, *t.shape[2:])).reshape(t.shape))

        h = self.conv1(norm(self.norm1, x))
        h = h + self.time_emb_proj(F.silu(emb))[:, None, None, None, :]
        h = self.conv2(norm(self.norm2, h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Lin(dim, inner * 2)

    def forward(self, x):
        hidden, gate = self.proj(x).chunk(2, dim=-1)
        return hidden * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), Lin(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, ctx_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.to_q = Lin(dim, dim, bias=False)
        self.to_k = Lin(ctx_dim or dim, dim, bias=False)
        self.to_v = Lin(ctx_dim or dim, dim, bias=False)
        self.to_out = nn.ModuleList([Lin(dim, dim)])

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx

        def heads(t):
            return t.reshape(*t.shape[:-1], self.heads, -1)

        out = attention(heads(self.to_q(x)), heads(self.to_k(ctx)), heads(self.to_v(ctx)))
        return self.to_out[0](out.reshape(*out.shape[:-2], -1))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ctx_dim: int):
        super().__init__()
        self.norm1, self.attn1 = LN(dim, 1e-5), CrossAttention(dim, heads)
        self.norm2, self.attn2 = LN(dim, 1e-5), CrossAttention(dim, heads, ctx_dim)
        self.norm3, self.ff = LN(dim, 1e-5), FeedForward(dim)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GroupNorm, 1x1 conv in, one transformer block over H*W tokens, 1x1
    conv out, residual; per frame."""

    def __init__(self, channels: int, heads: int, ctx_dim: int, groups: int):
        super().__init__()
        self.norm = GN(groups, channels, 1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(channels, heads, ctx_dim)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, ctx):
        b, f, h, w, c = x.shape
        t = self.norm(x.reshape(b * f, h * w, c))
        t = linear(t, self.proj_in.weight[:, :, 0, 0], self.proj_in.bias)
        ctx = ctx.repeat_interleave(f, dim=0)
        for block in self.transformer_blocks:
            t = block(t, ctx)
        t = linear(t, self.proj_out.weight[:, :, 0, 0], self.proj_out.bias)
        return t.reshape(x.shape) + x


def quantize(x: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes and scales, one scale per channel over ``dim``."""
    scale = x.abs().amax(dim=dim).clamp(min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale.unsqueeze(dim)), -127, 127)
    return q, scale


class Cache:
    """One temporal attention's KV cache: ``k``, ``v`` as ``[steps, window,
    HW, C]`` fp32. With ``int8`` each written slot holds its int8 codes
    times its per-channel scale, as the configuration stores it."""

    def __init__(self, steps: int, window: int, hw: int, c: int, int8: bool, device):
        self.k = torch.zeros(steps, window, hw, c, device=device)
        self.v = torch.zeros(steps, window, hw, c, device=device)
        self.int8 = int8

    def stored(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        if not self.int8:
            return t
        q, scale = quantize(t, dim)
        return q * scale.unsqueeze(dim)


class TemporalAttention(nn.Module):
    def __init__(self, dim: int, heads: int, pe_max_len: int, window: int):
        super().__init__()
        self.heads, self.pe_max_len, self.window = heads, pe_max_len, window
        self.to_q = Lin(dim, dim, bias=False)
        self.to_k = Lin(dim, dim, bias=False)
        self.to_v = Lin(dim, dim, bias=False)
        self.to_out = nn.ModuleList([Lin(dim, dim)])

    def forward(self, x, cache: Cache, mode: str, window_state=None, step_idx=None):
        """x ``[B, HW, F, C]``. ``warmup``: B = 1, the F frames' K/V written
        to slots 0..F-1 of step row ``step_idx``, attention over the clip with
        PEs 0..F-1. ``stream``: F = 1, B the step rows; each row's K/V go to
        slot ``update_idx[row]``, and its query (with the PE of that slot)
        attends over the row's window, keys and values plus their slots'
        PEs, under the mask."""
        b, hw, f, c = x.shape
        hd = self.heads
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        pe = pe_table(self.pe_max_len, c, x.device)[: self.window]
        pe_q, pe_k, pe_v = self.to_q(pe), self.to_k(pe), self.to_v(pe)
        if mode == "warmup":
            cache.k[step_idx, :f] = cache.stored(k[0], 0).transpose(0, 1)
            cache.v[step_idx, :f] = cache.stored(v[0], 0).transpose(0, 1)
            qh, kh, vh = ((t + p[None, None, :f]).reshape(b * hw, f, hd, -1)
                          for t, p in ((q, pe_q), (k, pe_k), (v, pe_v)))
            out = attention(qh, kh, vh).reshape(b, hw, f, c)
        else:
            mask, pe_idx, update_idx = window_state
            rows = torch.arange(b, device=x.device)
            cache.k[rows, update_idx] = cache.stored(k[:, :, 0], 1)
            cache.v[rows, update_idx] = cache.stored(v[:, :, 0], 1)
            q_full = q[:, :, 0] + pe_q[pe_idx[rows, update_idx]][:, None, :]  # [B, HW, C]
            k_full = cache.k + pe_k[pe_idx][:, :, None, :]  # [B, W, HW, C]
            v_full = cache.v + pe_v[pe_idx][:, :, None, :]
            qh = q_full.reshape(b, hw, hd, -1)
            kh = k_full.reshape(b, self.window, hw, hd, -1)
            vh = v_full.reshape(b, self.window, hw, hd, -1)
            logits = torch.einsum("bphd,bwphd->bphw", low(qh), low(kh)) * qh.shape[-1] ** -0.5
            logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
            p = torch.softmax(logits, dim=-1)
            out = torch.einsum("bphw,bwphd->bphd", low(p), low(vh)).reshape(b, hw, 1, c)
        return self.to_out[0](out)


class TemporalBlock(nn.Module):
    def __init__(self, dim: int, heads: int, n_attn: int, pe_max_len: int, window: int):
        super().__init__()
        self.attention_blocks = nn.ModuleList([TemporalAttention(dim, heads, pe_max_len, window)
                                               for _ in range(n_attn)])
        self.norms = nn.ModuleList([LN(dim, 1e-5) for _ in range(n_attn)])
        self.ff, self.ff_norm = FeedForward(dim), LN(dim, 1e-5)

    def forward(self, x, caches, *args):
        for attn, norm, cache in zip(self.attention_blocks, self.norms, caches):
            x = x + attn(norm(x), cache, *args)
        return x + self.ff(self.ff_norm(x))


class TemporalTransformer(nn.Module):
    def __init__(self, channels: int, heads: int, n_blocks: int, n_attn: int, groups: int,
                 pe_max_len: int, window: int):
        super().__init__()
        self.n_attn = n_attn
        self.norm = GN(groups, channels, 1e-6)
        self.proj_in = Lin(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            TemporalBlock(channels, heads, n_attn, pe_max_len, window) for _ in range(n_blocks)])
        self.proj_out = Lin(channels, channels)

    def forward(self, x, caches, *args):
        b, f, h, w, c = x.shape
        t = self.norm(x.reshape(b * f, h * w, c))
        t = self.proj_in(t).reshape(b, f, h * w, c).transpose(1, 2)
        for i, block in enumerate(self.transformer_blocks):
            t = block(t, caches[i * self.n_attn:(i + 1) * self.n_attn], *args)
        return self.proj_out(t.transpose(1, 2).reshape(x.shape)) + x


class MotionModule(nn.Module):
    def __init__(self, *args):
        super().__init__()
        self.temporal_transformer = TemporalTransformer(*args)

    def forward(self, *args):
        return self.temporal_transformer(*args)


class MappingNetwork(nn.Module):
    """The depth-conditioning encoder: 3x3 convs with SiLU."""

    def __init__(self, out_channels: int, widths: Sequence[int], cin: int = 4):
        super().__init__()
        self.conv_in = Conv(cin, widths[0], 3, padding=1)
        blocks = []
        for a, b in zip(widths[:-1], widths[1:]):
            blocks += [Conv(a, a, 3, padding=1), Conv(a, b, 3, padding=1)]
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = Conv(widths[-1], out_channels, 3, padding=1)

    def forward(self, x):
        x = F.silu(self.conv_in(x))
        for block in self.blocks:
            x = F.silu(block(x))
        return self.conv_out(x)


class _Block(nn.Module):
    def __init__(self):
        super().__init__()
        for name in ("resnets", "attentions", "motion_modules", "downsamplers", "upsamplers"):
            setattr(self, name, nn.ModuleList())


class _Resample(nn.Module):
    def __init__(self, channels: int, stride: int):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=stride, padding=1)


def level_dims(h: int, w: int, levels: int) -> List[Tuple[int, int]]:
    """The latent's spatial dims at each UNet level (ceil-halving)."""
    dims = [(h, w)]
    for _ in range(levels - 1):
        dims.append((-(-dims[-1][0] // 2), -(-dims[-1][1] // 2)))
    return dims


class UNet(nn.Module):
    """The SD-1.5 UNet with depth mapping and motion modules, as the
    configuration's ``unet`` section gives it."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        ch = cfg["block_out_channels"]
        temb = ch[0] * 4
        groups, eps = cfg["norm_num_groups"], cfg["norm_eps"]
        n = len(ch)
        mres = cfg["motion_module_resolutions"]

        def motion(c):
            return MotionModule(c, cfg["motion_num_attention_heads"],
                                cfg["motion_num_transformer_block"],
                                len(cfg["motion_attention_block_types"]), groups,
                                cfg["motion_pe_max_len"], cfg["window_size"])

        def spatial(c):
            return SpatialTransformer(c, cfg["attention_head_dim"], cfg["cross_attention_dim"],
                                      groups)

        self.conv_in = Conv(cfg["in_channels"], ch[0], 3, padding=1)
        self.time_embedding = TimeEmbedding(ch[0], temb)
        self.flow_conv_in = (MappingNetwork(ch[0], cfg["mapping_channels"])
                             if cfg["cond_mapping"] else None)
        skips, cur = [ch[0]], ch[0]
        self.down_blocks = nn.ModuleList()
        for i, kind in enumerate(cfg["down_block_types"]):
            blk = _Block()
            for _ in range(cfg["layers_per_block"]):
                blk.resnets.append(Resnet(cur, ch[i], temb, groups, eps))
                cur = ch[i]
                if kind == "CrossAttnDownBlock3D":
                    blk.attentions.append(spatial(cur))
                if 2 ** i in mres:
                    blk.motion_modules.append(motion(cur))
                skips.append(cur)
            if i < n - 1:
                blk.downsamplers.append(_Resample(cur, 2))
                skips.append(cur)
            self.down_blocks.append(blk)
        self.mid_block = _Block()
        self.mid_block.resnets.extend([Resnet(cur, ch[-1], temb, groups, eps),
                                       Resnet(ch[-1], ch[-1], temb, groups, eps)])
        self.mid_block.attentions.append(spatial(ch[-1]))
        cur = ch[-1]
        rev = list(reversed(ch))
        self.up_blocks = nn.ModuleList()
        for i, kind in enumerate(cfg["up_block_types"]):
            blk = _Block()
            for _ in range(cfg["layers_per_block"] + 1):
                blk.resnets.append(Resnet(cur + skips.pop(), rev[i], temb, groups, eps))
                cur = rev[i]
                if kind == "CrossAttnUpBlock3D":
                    blk.attentions.append(spatial(cur))
                if 2 ** (n - 1 - i) in mres:
                    blk.motion_modules.append(motion(cur))
            if i < n - 1:
                blk.upsamplers.append(_Resample(cur, 1))
            self.up_blocks.append(blk)
        self.conv_norm_out = GN(groups, ch[0], eps)
        self.conv_out = Conv(ch[0], cfg["out_channels"], 3, padding=1)

    def motion_channels(self) -> List[Tuple[int, int]]:
        """(channels, level) of every temporal attention, in call order."""
        out = []
        for level, blk in enumerate(self.down_blocks):
            for mm in blk.motion_modules:
                out += [(mm.temporal_transformer.proj_in.in_features, level)] * len(
                    list(_attentions(mm)))
        n = len(self.up_blocks)
        for i, blk in enumerate(self.up_blocks):
            for mm in blk.motion_modules:
                out += [(mm.temporal_transformer.proj_in.in_features, n - 1 - i)] * len(
                    list(_attentions(mm)))
        return out

    def forward(self, sample, timesteps, ctx, depth, caches: Sequence[Cache], mode: str,
                window_state=None, step_idx=None):
        """sample, depth ``[B, F, h, w, 4]``; ctx ``[B, L, D]``."""
        emb = self.time_embedding(timestep_embedding(timesteps, self.cfg["block_out_channels"][0]))
        x = self.conv_in(sample)
        if self.flow_conv_in is not None:
            x = x + self.flow_conv_in(depth)
        it = iter(caches)
        per = self.cfg["motion_num_transformer_block"] * len(
            self.cfg["motion_attention_block_types"])

        def motion(mm, x):
            return mm(x, [next(it) for _ in range(per)], mode, window_state, step_idx)

        stack = [x]
        for blk in self.down_blocks:
            for i, resnet in enumerate(blk.resnets):
                x = resnet(x, emb)
                if len(blk.attentions):
                    x = blk.attentions[i](x, ctx)
                if len(blk.motion_modules):
                    x = motion(blk.motion_modules[i], x)
                stack.append(x)
            for down in blk.downsamplers:
                x = down.conv(x)
                stack.append(x)
        x = self.mid_block.resnets[0](x, emb)
        x = self.mid_block.attentions[0](x, ctx)
        x = self.mid_block.resnets[1](x, emb)
        for blk in self.up_blocks:
            for i, resnet in enumerate(blk.resnets):
                x = resnet(torch.cat([x, stack.pop()], dim=-1), emb)
                if len(blk.attentions):
                    x = blk.attentions[i](x, ctx)
                if len(blk.motion_modules):
                    x = motion(blk.motion_modules[i], x)
            for up in blk.upsamplers:
                th, tw = stack[-1].shape[2:4]
                h, w = x.shape[2:4]
                rows = torch.div(torch.arange(th, device=x.device) * h, th, rounding_mode="floor")
                cols = torch.div(torch.arange(tw, device=x.device) * w, tw, rounding_mode="floor")
                x = up.conv(x[:, :, rows][:, :, :, cols])
        b, f = x.shape[:2]
        x = F.silu(self.conv_norm_out(x.reshape(b * f, *x.shape[2:]))).reshape(x.shape)
        return self.conv_out(x)


def _attentions(mm):
    for block in mm.temporal_transformer.transformer_blocks:
        yield from block.attention_blocks


# ---------------------------------------------------------------------------
# TAESD
# ---------------------------------------------------------------------------


class TConv(nn.Module):
    """3x3 padding-1 conv, optional bias, optional skip added, optional ReLU."""

    def __init__(self, cin: int, cout: int, relu: bool = False, bias: bool = True,
                 stride: int = 1):
        super().__init__()
        self.relu, self.stride = relu, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x, skip=None):
        y = conv(x, self.weight, self.bias, self.stride, 1)
        if skip is not None:
            y = y + skip
        return torch.relu(y) if self.relu else y


class TinyBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.ModuleList([TConv(cin, cout, relu=True), nn.ReLU(),
                                   TConv(cout, cout, relu=True), nn.ReLU(),
                                   TConv(cout, cout, relu=True)])
        self.skip = nn.Conv2d(cin, cout, 1, bias=False) if cin != cout else None

    def forward(self, x):
        h = self.conv[2](self.conv[0](x))
        skip = x if self.skip is None else conv(x, self.skip.weight)
        return self.conv[4](h, skip)


class TinyEncoder(nn.ModuleList):
    def __init__(self, latent: int, hidden: int, blocks: Sequence[int]):
        layers = [TConv(3, hidden)]
        for stage, n in enumerate(blocks):
            if stage:
                layers.append(TConv(hidden, hidden, bias=False, stride=2))
            layers += [TinyBlock(hidden, hidden) for _ in range(n)]
        layers.append(nn.Conv2d(hidden, latent, 3, padding=1))
        super().__init__(layers)

    def forward(self, x):
        for layer in list(self)[:-1]:
            x = layer(x)
        return conv(x, self[-1].weight, self[-1].bias, 1, 1)


class TinyDecoder(nn.ModuleList):
    def __init__(self, latent: int, hidden: int):
        layers = [nn.Identity(), nn.Conv2d(latent, hidden, 3, padding=1), nn.ReLU()]
        for _ in range(3):
            layers += [TinyBlock(hidden, hidden) for _ in range(3)]
            layers += [nn.Upsample(scale_factor=2), TConv(hidden, hidden, bias=False)]
        layers += [TinyBlock(hidden, hidden), nn.Conv2d(hidden, 3, 3, padding=1)]
        super().__init__(layers)

    def forward(self, z):
        x = torch.tanh(z / 3.0) * 3.0
        x = torch.relu(conv(x, self[1].weight, self[1].bias, 1, 1))
        for layer in list(self)[3:-1]:
            if isinstance(layer, nn.Upsample):
                x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            else:
                x = layer(x)
        return conv(x, self[-1].weight, self[-1].bias, 1, 1)


class TAESD(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.encoder = TinyEncoder(cfg["latent_channels"], cfg["hidden"], cfg["encoder_blocks"])
        self.decoder = TinyDecoder(cfg["latent_channels"], cfg["hidden"])

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Images ``[N, H, W, 3]`` in [-1, 1] -> latents ``[N, H/8, W/8, 4]``:
        TAESD's latents are in the UNet's scale already."""
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)


# ---------------------------------------------------------------------------
# DPT-hybrid
# ---------------------------------------------------------------------------


def resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of ``[N, H, W, C]``, half-pixel centres, no antialias."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


class StdConv(nn.Conv2d):
    """Weight-standardised conv: each output channel's kernel to zero mean
    and unit (population) variance, eps 1e-8 inside the square root."""

    def forward(self, x):
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), keepdim=True, unbiased=False)
        return conv(x, (w - mean) / torch.sqrt(var + 1e-8), self.bias, self.stride[0],
                    self.padding[0])


class _Down(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv = StdConv(cin, cout, 1, stride, 0, bias=False)
        self.norm = GN(32, cout, 1e-5)

    def forward(self, x):
        return self.norm(self.conv(x))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        mid = cout // 4
        self.downsample = _Down(cin, cout, stride) if cin != cout or stride != 1 else None
        self.conv1, self.norm1 = StdConv(cin, mid, 1, bias=False), GN(32, mid, 1e-5)
        self.conv2, self.norm2 = StdConv(mid, mid, 3, stride, 1, bias=False), GN(32, mid, 1e-5)
        self.conv3, self.norm3 = StdConv(mid, cout, 1, bias=False), GN(32, cout, 1e-5)

    def forward(self, x):
        short = x if self.downsample is None else self.downsample(x)
        h = torch.relu(self.norm1(self.conv1(x)))
        h = torch.relu(self.norm2(self.conv2(h)))
        return torch.relu(self.norm3(self.conv3(h)) + short)


class ViTBlock(nn.Module):
    def __init__(self, d: int, heads: int, mlp: int):
        super().__init__()
        self.heads = heads
        self.norm1, self.norm2 = LN(d, 1e-6), LN(d, 1e-6)
        self.attn = nn.Module()
        self.attn.qkv, self.attn.proj = Lin(d, 3 * d), Lin(d, d)
        self.mlp = nn.Module()
        self.mlp.fc1, self.mlp.fc2 = Lin(d, mlp), Lin(mlp, d)

    def forward(self, x):
        q, k, v = (t.reshape(*t.shape[:-1], self.heads, -1)
                   for t in self.attn.qkv(self.norm1(x)).chunk(3, -1))
        x = x + self.attn.proj(attention(q, k, v).reshape(x.shape))
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))


class RCU(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.conv1, self.conv2 = Conv(f, f, 3, padding=1), Conv(f, f, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(torch.relu(self.conv1(torch.relu(x))))


class Fusion(nn.Module):
    def __init__(self, f: int, skip: bool):
        super().__init__()
        self.resConfUnit1 = RCU(f) if skip else None
        self.resConfUnit2 = RCU(f)
        self.out_conv = Conv(f, f, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        return self.out_conv(resize(x, x.shape[1] * 2, x.shape[2] * 2))


def _module(**children) -> nn.Module:
    m = nn.Module()
    for k, v in children.items():
        setattr(m, k, v)
    return m


class DPT(nn.Module):
    """vitb_rn50_384: ``[B, 384, 384, 3]`` -> ``[B, 384, 384]``."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        d, g, f = cfg["vit_hidden"], cfg["patch_grid"], cfg["features"]
        stage_ch = cfg["stage_channels"]
        stem = _module(conv=StdConv(3, 64, 7, 2, 3, bias=False), norm=GN(32, 64, 1e-5))
        stages, cin = nn.ModuleList(), 64
        for s, (cout, n) in enumerate(zip(stage_ch, cfg["resnet_layers"])):
            stages.append(_module(blocks=nn.ModuleList([
                Bottleneck(cin if i == 0 else cout, cout, (1 if s == 0 else 2) if i == 0 else 1)
                for i in range(n)])))
            cin = cout
        vit = _module(
            patch_embed=_module(backbone=_module(stem=stem, stages=stages),
                                proj=nn.Conv2d(stage_ch[-1], d, 1)),
            blocks=nn.ModuleList([ViTBlock(d, cfg["vit_heads"], cfg["vit_mlp"])
                                  for _ in range(cfg["vit_layers"])]))
        vit.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        vit.pos_embed = nn.Parameter(torch.zeros(1, g * g + 1, d))
        r = cfg["reassemble_channels"]

        def readout(down):
            slots = [_module(project=nn.Sequential(Lin(2 * d, d), nn.GELU())), nn.Identity(),
                     nn.Identity(), nn.Conv2d(d, r, 1)]
            if down:
                slots.append(nn.Conv2d(r, r, 3, stride=2, padding=1))
            return nn.ModuleList(slots)

        self.pretrained = _module(model=vit, act_postprocess3=readout(False),
                                  act_postprocess4=readout(True))
        taps = (stage_ch[0], stage_ch[1], r, r)
        scratch = nn.Module()
        for i, c in enumerate(taps, start=1):
            setattr(scratch, f"layer{i}_rn", Conv(c, f, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(scratch, f"refinenet{i}", Fusion(f, i < 4))
        scratch.output_conv = nn.ModuleList([Conv(f, f // 2, 3, padding=1), nn.Identity(),
                                             Conv(f // 2, 32, 3, padding=1), nn.ReLU(),
                                             Conv(32, 1, 1), nn.ReLU()])
        self.scratch = scratch

    def forward(self, x):
        cfg = self.cfg
        b, g, d = x.shape[0], cfg["patch_grid"], cfg["vit_hidden"]
        vit = self.pretrained.model
        bb = vit.patch_embed.backbone
        h = torch.relu(bb.stem.norm(bb.stem.conv(x)))
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        taps = []
        for s, stage in enumerate(bb.stages):
            for block in stage.blocks:
                h = block(h)
            if s < 2:
                taps.append(h)
        p = vit.patch_embed.proj
        t = conv(h, p.weight, p.bias).reshape(b, g * g, d)
        t = torch.cat([vit.cls_token.expand(b, 1, d), t], dim=1) + vit.pos_embed
        hooks = {}
        for i, block in enumerate(vit.blocks):
            t = block(t)
            if i in cfg["hooks"]:
                hooks[i] = t

        def read(post, tokens):
            patch = tokens[:, 1:]
            y = post[0].project(torch.cat([patch, tokens[:, :1].expand_as(patch)], dim=-1))
            y = y.reshape(b, g, g, d)
            y = conv(y, post[3].weight, post[3].bias)
            if len(post) > 4:
                y = conv(y, post[4].weight, post[4].bias, 2, 1)
            return y

        l3 = read(self.pretrained.act_postprocess3, hooks[cfg["hooks"][0]])
        l4 = read(self.pretrained.act_postprocess4, hooks[cfg["hooks"][1]])
        sc = self.scratch
        path = sc.refinenet4(sc.layer4_rn(l4))
        path = sc.refinenet3(path, sc.layer3_rn(l3))
        path = sc.refinenet2(path, sc.layer2_rn(taps[1]))
        path = sc.refinenet1(path, sc.layer1_rn(taps[0]))
        out = sc.output_conv
        h = out[0](path)
        h = resize(h, h.shape[1] * 2, h.shape[2] * 2)
        h = torch.relu(out[2](h))
        return torch.relu(out[4](h))[..., 0]


def models(cfg: dict) -> Dict[str, nn.Module]:
    """The stream's models as the configuration gives them: the UNet, TAESD
    and, with depth, the DPT-hybrid. A configuration's own reference module
    (``stream.reference_module``) defines the same function."""
    out = {"unet": UNet(cfg["unet"]), "vae": TAESD(cfg["taesd"])}
    if cfg["use_depth"]:
        out["depth"] = DPT(cfg["dpt"])
    return out
