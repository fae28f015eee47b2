"""Spatial transformer blocks (per-frame self-attention + text cross-attention).

Port of ``live2diff_tpu/models/attention.py``: the SD-1.5 spatial
transformer applied framewise over ``[B, F, H, W, C]``. Attention runs
through ``ops.attention.dot_product_attention``, so on the card both the
self- and the cross-attention launch a flash kernel: the self-attention the
pipeline's ``flash_variant`` where the flash gate passes (S >= 1024), the
d-major kernel elsewhere.

``cross_frame_attention`` is the original's ``SparseCausalAttention``: over
a clip of ``video_length`` > 1 frames (the warmup), each frame's
self-attention keys are those of frame 0 of its clip, its values its own
(``live2diff_tpu/models/attention.py:64-69``); over one frame (stream
mode) it is ordinary self-attention.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.choices import DEFAULT_KERNELS, KernelChoices
from ..parallel.tp import row_linear, tp_copy
from .layers import FusedGroupNorm, FusedLayerNorm, GEGLUFeedForward


class CrossAttention(nn.Module):
    """Multi-head attention with an optional cross-attention source; q/k/v
    carry no bias, the output projection does (diffusers ``Attention``). A
    self-attention takes ``kernels.flash_variant``; a cross-attention the
    d-major kernel. ``cross_frame`` takes the keys of each clip's frame 0.
    A tp block (``parallel/tp.py``): sharded, it holds H/tp heads, its head
    count read from its own projections."""

    tp = None  # the tp group once parallel.tp.shard_params shards it

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None, cross_frame: bool = False,
                 kernels: KernelChoices = DEFAULT_KERNELS):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.cross_frame = heads, dim_head, cross_frame
        self.flash_variant = "dmajor" if cross_attention_dim else kernels.flash_variant
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(cross_attention_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(cross_attention_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def tp_divides(self, tp: int) -> bool:
        return self.heads % tp == 0

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                video_length: Optional[int] = None) -> torch.Tensor:
        hidden_states = tp_copy(hidden_states, self.tp)
        ctx = (hidden_states if encoder_hidden_states is None
               else tp_copy(encoder_hidden_states, self.tp))
        k = self.to_k(ctx)  # [B*F, S, inner / tp]
        if self.cross_frame:
            if video_length is None:
                raise ValueError("cross-frame attention needs video_length")
            if video_length > 1:
                bf, s, c = k.shape
                k = k.reshape(bf // video_length, video_length, s, c)[:, :1]
                k = k.expand(-1, video_length, -1, -1).reshape(bf, s, c)

        def split_heads(x):  # this rank's heads
            return x.reshape(*x.shape[:-1], -1, self.dim_head)

        out = dot_product_attention(
            split_heads(self.to_q(hidden_states)),
            split_heads(k),
            split_heads(self.to_v(ctx)),
            flash_variant=self.flash_variant,
        )
        return row_linear(out.reshape(*out.shape[:-2], -1), self.to_out[0], self.tp)


class BasicTransformerBlock(nn.Module):
    """LayerNorm -> self-attn -> LayerNorm -> cross-attn -> LayerNorm -> GEGLU FF."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_attention_dim: int = 768,
                 cross_frame_attention: bool = False, kernels: KernelChoices = DEFAULT_KERNELS):
        super().__init__()
        self.norm1 = FusedLayerNorm(dim, 1e-5, site="spatial", kernels=kernels)
        self.attn1 = CrossAttention(dim, heads, dim_head, cross_frame=cross_frame_attention,
                                    kernels=kernels)
        self.norm2 = FusedLayerNorm(dim, 1e-5, site="spatial", kernels=kernels)
        self.attn2 = CrossAttention(dim, heads, dim_head, cross_attention_dim)
        self.norm3 = FusedLayerNorm(dim, 1e-5, site="spatial", kernels=kernels)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x: torch.Tensor, encoder_hidden_states: torch.Tensor,
                video_length: Optional[int] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x), video_length=video_length)
        x = x + self.attn2(self.norm2(x), encoder_hidden_states)
        return x + self.ff(self.norm3(x))


class Transformer3DModel(nn.Module):
    """GroupNorm -> 1x1 conv proj_in -> transformer blocks over H*W tokens ->
    1x1 conv proj_out -> residual, per frame (SD-1.5: conv projections)."""

    def __init__(self, channels: int, heads: int, dim_head: int, num_layers: int = 1,
                 cross_attention_dim: int = 768, cross_frame_attention: bool = False,
                 norm_num_groups: int = 32, kernels: KernelChoices = DEFAULT_KERNELS):
        super().__init__()
        inner = heads * dim_head
        self.norm = FusedGroupNorm(norm_num_groups, channels, 1e-6, site="attn_in",
                                   kernels=kernels)
        self.proj_in = nn.Conv2d(channels, inner, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, cross_attention_dim,
                                  cross_frame_attention, kernels)
            for _ in range(num_layers)
        ])
        self.proj_out = nn.Conv2d(inner, channels, 1)

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        b, f, h, w, c = hidden_states.shape
        x = self.norm(hidden_states.reshape(b * f, h * w, c))
        # 1x1 convs as linear maps over the channel axis
        x = F.linear(x, self.proj_in.weight[:, :, 0, 0], self.proj_in.bias)
        ctx = encoder_hidden_states.repeat_interleave(f, dim=0)  # text repeats per frame
        for block in self.transformer_blocks:
            x = block(x, ctx, video_length=f)
        x = F.linear(x, self.proj_out.weight[:, :, 0, 0], self.proj_out.bias)
        return x.reshape(b, f, h, w, c) + hidden_states
