"""Temporal motion modules: windowed attention over a streaming KV cache.

Port of ``live2diff_tpu/models/motion.py``. Each motion module is a
temporal transformer whose self-attention runs along the frame axis in one
of three modes:

* ``clip``: training. Bidirectional attention over the clip with the
  absolute positional encodings 0..F-1 added to q, k and v; the caches are
  not read or written, and come back as they were passed (the trainer
  passes empty ones);
* ``warmup``: bidirectional attention over the warmup frames, which also
  writes their PE-free K/V into cache slots 0..F-1 of the current step row;
* ``stream``: one new frame per denoising step. Its K/V go into slot
  ``update_idx[step]`` and its query attends over the whole window under an
  additive visibility bias; the positional encodings are pre-projected
  rows gathered by ``pe_idx`` at attention time, never stored in the cache.

Cache geometry, as in the JAX package: ``[steps, 2, window, C, HW]`` (2 = K
and V; positions minor). The int8 cache is a (data, scales) pair with
symmetric per-(slot, channel) scales.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.attention import dot_product_attention, stream_window_attention
from ..ops.choices import DEFAULT_KERNELS, KernelChoices
from ..parallel.tp import row_linear, tp_copy
from ..stream.state import KVCache
from .layers import (FusedGroupNorm, FusedLayerNorm, GEGLUFeedForward, Linear,
                     sinusoidal_table)


# one 0-dim 127.0 per device, made at first use
_DIVISORS: Dict[torch.device, torch.Tensor] = {}


def _divisor_127(device: torch.device) -> torch.Tensor:
    """127.0 as a 0-dim tensor on ``device``. On CUDA, torch divides by a
    Python scalar through its reciprocal, which can move a scale one ulp off
    the true quotient (and some codes with it); a tensor divisor divides.
    Made once, so a step adds no launch and no host-to-device copy."""
    t = _DIVISORS.get(device)
    if t is None:
        t = _DIVISORS[device] = torch.tensor(127.0, dtype=torch.float32, device=device)
    return t


@functools.lru_cache(maxsize=None)
def _step_rows(steps: int, device: torch.device) -> torch.Tensor:
    """``arange(steps)`` on ``device``, the row index of every stream cache
    write; made once, so the 40 writes of a step add no launch for it."""
    return torch.arange(steps, device=device)


def _quantize_kv(x: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation with per-channel scales.

    x: [..., C]; the absmax is taken over ``dim`` (the spatial axis) only.
    Rounds half to even (``torch.round``, as ``jnp.round``) and clips to
    +-127. Returns (int8 values, f32 scales with ``dim`` dropped).
    """
    xf = x.float()
    amax = xf.abs().amax(dim=dim)
    scale = torch.clamp(amax, min=1e-8) / _divisor_127(xf.device)
    q = torch.clamp(torch.round(xf / scale.unsqueeze(dim)), -127, 127).to(torch.int8)
    return q, scale


def write_kv_stream(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                    update_idx: torch.Tensor) -> KVCache:
    """Write the new frame's K/V ([steps, HW, C] each) into slot
    ``update_idx[step]`` of each step row.

    The write is in place: the caches are the stream's state and are not
    needed in their old form (the port's counterpart of the JAX package's
    buffer donation). One indexed write covers all steps.
    """
    if isinstance(cache, tuple):
        data, scales = cache
        steps = data.shape[0]
        k8, ks = _quantize_kv(k, 1)  # [steps, HW, C] -> scales [steps, C]
        v8, vs = _quantize_kv(v, 1)
        rows = _step_rows(steps, data.device)
        data[rows, :, update_idx] = torch.stack([k8, v8], dim=1).transpose(-1, -2)
        scales[rows, :, update_idx] = torch.stack([ks, vs], dim=1)
        return data, scales
    steps = cache.shape[0]
    rows = _step_rows(steps, cache.device)
    cache[rows, :, update_idx] = torch.stack([k, v], dim=1).transpose(-1, -2).to(cache.dtype)
    return cache


def write_kv_warmup(cache: KVCache, k: torch.Tensor, v: torch.Tensor, step_idx: int) -> KVCache:
    """Fill slots 0..F-1 of step row ``step_idx`` with the warmup K/V
    ([HW, F, C] each), in place."""
    f = k.shape[1]
    if isinstance(cache, tuple):
        data, scales = cache
        k8, ks = _quantize_kv(k, 0)  # [HW, F, C] -> scales [F, C]
        v8, vs = _quantize_kv(v, 0)
        data[step_idx, :, :f] = torch.stack([k8, v8], dim=0).permute(0, 2, 3, 1)
        scales[step_idx, :, :f] = torch.stack([ks, vs], dim=0)
        return data, scales
    cache[step_idx, :, :f] = torch.stack([k, v], dim=0).permute(0, 2, 3, 1).to(cache.dtype)
    return cache


class TemporalAttention(nn.Module):
    """Temporal self-attention with clip / warmup / stream behaviour. A tp
    block (``parallel/tp.py``): sharded, it holds H/tp heads, C/tp channels
    of q, k, v and of its KV cache (the channel slab of its heads), and
    reads its width from its own projections."""

    tp = None  # the tp group once parallel.tp.shard_params shards it

    def __init__(self, dim: int, heads: int = 8, pe_max_len: int = 24, window_size: int = 16):
        super().__init__()
        self.heads, self.pe_max_len, self.window_size = heads, pe_max_len, window_size
        self.dim_head = dim // heads
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(dim, dim, bias=False)
        self.to_v = Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim)])

    def tp_divides(self, tp: int) -> bool:
        return self.heads % tp == 0

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, HW, F, C]
        kv_cache: KVCache,
        mode: str,
        attn_bias: Optional[torch.Tensor] = None,  # [steps, window]
        pe_idx: Optional[torch.Tensor] = None,  # [steps, window]
        update_idx: Optional[torch.Tensor] = None,  # [steps]
        warmup_step_idx: Optional[int] = None,
    ) -> Tuple[torch.Tensor, KVCache]:
        b, hw, f, c = hidden_states.shape
        x = tp_copy(hidden_states, self.tp)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        cl, dh = q.shape[-1], self.dim_head  # this rank's width: C/tp of H/tp heads
        heads = cl // dh
        # pre-projected positional encodings (PE stays out of the cache);
        # the column slabs give this rank's heads' share of them
        pe = sinusoidal_table(self.pe_max_len, c, q.device, q.dtype)[: self.window_size]
        pe_q, pe_k, pe_v = self.to_q(pe), self.to_k(pe), self.to_v(pe)  # [window, C/tp]

        if mode in ("clip", "warmup"):
            new_cache = (write_kv_warmup(kv_cache, k[0], v[0], warmup_step_idx)
                         if mode == "warmup" else kv_cache)
            # bidirectional attention over the clip with absolute PE 0..f-1
            q = q + pe_q[None, None, :f]
            k = k + pe_k[None, None, :f]
            v = v + pe_v[None, None, :f]
            out = dot_product_attention(
                q.reshape(b, hw, f, heads, dh), k.reshape(b, hw, f, heads, dh),
                v.reshape(b, hw, f, heads, dh),
            ).reshape(b, hw, f, cl)
        elif mode == "stream":
            if f != 1:
                raise ValueError("stream mode processes one frame per denoising step")
            new_cache = write_kv_stream(kv_cache, k[:, :, 0], v[:, :, 0], update_idx)
            q_pe_idx = torch.gather(pe_idx, 1, update_idx[:, None])[:, 0]  # [steps]
            if attn_bias is None:
                attn_bias = torch.zeros((b, self.window_size), device=q.device)
            out = stream_window_attention(
                q[:, :, 0], new_cache, pe_q[q_pe_idx], pe_k[pe_idx], pe_v[pe_idx],
                attn_bias, heads,
            ).reshape(b, hw, 1, cl)
        else:
            raise ValueError(f"unknown mode: {mode}")
        return row_linear(out, self.to_out[0], self.tp), new_cache


class TemporalTransformerBlock(nn.Module):
    """Two temporal self-attentions + GEGLU feed-forward, all residual."""

    def __init__(self, dim: int, heads: int, num_attention_blocks: int = 2,
                 pe_max_len: int = 24, window_size: int = 16,
                 kernels: KernelChoices = DEFAULT_KERNELS):
        super().__init__()
        self.attention_blocks = nn.ModuleList([
            TemporalAttention(dim, heads, pe_max_len, window_size)
            for _ in range(num_attention_blocks)
        ])
        self.norms = nn.ModuleList([
            FusedLayerNorm(dim, 1e-5, site="temporal", kernels=kernels)
            for _ in range(num_attention_blocks)
        ])
        self.ff = GEGLUFeedForward(dim)
        self.ff_norm = FusedLayerNorm(dim, 1e-5, site="temporal", kernels=kernels)

    def forward(self, x: torch.Tensor, kv_caches: Sequence[KVCache], mode: str, *args):
        new_caches = []
        for attn, norm, cache in zip(self.attention_blocks, self.norms, kv_caches):
            out, cache = attn(norm(x), cache, mode, *args)
            x = x + out
            new_caches.append(cache)
        return x + self.ff(self.ff_norm(x)), new_caches


class TemporalTransformer3DModel(nn.Module):
    """GroupNorm -> linear proj_in -> temporal blocks -> proj_out + residual,
    over ``[B, F, H, W, C]``; spatial positions fold into the batch."""

    def __init__(self, channels: int, heads: int = 8, num_layers: int = 1,
                 num_attention_blocks: int = 2, norm_num_groups: int = 32,
                 pe_max_len: int = 24, window_size: int = 16,
                 kernels: KernelChoices = DEFAULT_KERNELS):
        super().__init__()
        self.caches_per_block = num_attention_blocks
        self.norm = FusedGroupNorm(norm_num_groups, channels, 1e-6, site="motion_in",
                                   kernels=kernels)
        self.proj_in = Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            TemporalTransformerBlock(channels, heads, num_attention_blocks, pe_max_len,
                                     window_size, kernels)
            for _ in range(num_layers)
        ])
        self.proj_out = Linear(channels, channels)

    def forward(self, hidden_states: torch.Tensor, kv_caches: Sequence[KVCache], mode: str,
                *args) -> Tuple[torch.Tensor, list]:
        b, f, h, w, c = hidden_states.shape
        x = self.norm(hidden_states.reshape(b * f, h * w, c))  # per-frame statistics
        x = self.proj_in(x).reshape(b, f, h * w, c).transpose(1, 2)  # [B, HW, F, C]
        cpb = self.caches_per_block
        new_caches = []
        for i, block in enumerate(self.transformer_blocks):
            x, updated = block(x, kv_caches[i * cpb:(i + 1) * cpb], mode, *args)
            new_caches.extend(updated)
        x = self.proj_out(x.transpose(1, 2).reshape(b, f, h, w, c))
        return x + hidden_states, new_caches


class MotionModule(nn.Module):
    """The AnimateDiff ``VanillaTemporalModule`` level: holds the temporal
    transformer under the checkpoint's ``temporal_transformer`` key."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.temporal_transformer = TemporalTransformer3DModel(*args, **kwargs)

    def forward(self, *args):
        return self.temporal_transformer(*args)
