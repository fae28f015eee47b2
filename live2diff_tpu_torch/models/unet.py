"""The inflated SD-1.5 UNet with depth conditioning and streaming motion modules.

Port of ``live2diff_tpu/models/unet.py``. One module serves training,
warmup and stream mode (``mode='clip' | 'warmup' | 'stream'``); only the
temporal attention differs. Layout is channels-last video ``[B, F, H, W,
C]``: in stream mode B is the denoising-step batch and F == 1; in warmup
mode B == 1 and F is the number of warmup frames; in clip mode B is the
batch of training clips and F their length, and the caches are empty
placeholders that come back unchanged.

The KV caches are a flat tuple, one per temporal attention layer, in
forward-traversal order (down blocks, then up blocks), threaded through the
blocks and updated in place. Submodule names follow the diffusers /
AnimateDiff checkpoint keys (``down_blocks.0.resnets.1.conv1``,
``...motion_modules.0.temporal_transformer...``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.choices import DEFAULT_KERNELS, KernelChoices
from ..stream.state import KVCache
from .attention import Transformer3DModel
from .layers import FusedGroupNorm, TimestepEmbedding, timestep_embedding
from .motion import MotionModule
from .resnet import Downsample3D, InflatedConv, MappingNetwork, ResnetBlock3D, Upsample3D


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Static architecture config (SD-1.5 defaults + Live2Diff motion setup)."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock3D", "CrossAttnDownBlock3D", "CrossAttnDownBlock3D", "DownBlock3D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock3D", "CrossAttnUpBlock3D", "CrossAttnUpBlock3D", "CrossAttnUpBlock3D",
    )
    layers_per_block: int = 2
    attention_head_dim: int = 8  # number of spatial attention heads (SD-1.5 naming)
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    cond_mapping: bool = True  # depth conditioning branch
    use_motion_module: bool = True
    motion_module_resolutions: Tuple[int, ...] = (1, 2, 4, 8)
    motion_num_attention_heads: int = 8
    motion_num_transformer_block: int = 1
    motion_attention_block_types: Tuple[str, ...] = ("Temporal_Self", "Temporal_Self")
    motion_pe_max_len: int = 24
    window_size: int = 16
    sink_size: int = 8
    # SparseCausalAttention in the spatial self-attentions; off in every
    # shipped config
    unet_use_cross_frame_attention: bool = False

    @property
    def caches_per_module(self) -> int:
        return self.motion_num_transformer_block * len(self.motion_attention_block_types)

    def motion_module_layout(self) -> Tuple[Tuple[int, int], ...]:
        """(channels, resolution_divisor) of every motion module, traversal order."""
        layout = []
        for i in range(len(self.block_out_channels)):
            res = 2**i
            if self.use_motion_module and res in self.motion_module_resolutions:
                layout += [(self.block_out_channels[i], res)] * self.layers_per_block
        rev = list(reversed(self.block_out_channels))
        for i in range(len(self.block_out_channels)):
            res = 2 ** (len(self.block_out_channels) - 1 - i)
            if self.use_motion_module and res in self.motion_module_resolutions:
                layout += [(rev[i], res)] * (self.layers_per_block + 1)
        return tuple(layout)

    def num_caches(self) -> int:
        return len(self.motion_module_layout()) * self.caches_per_module

    def motion_tp(self, tp: int) -> int:
        """The ranks a motion module's heads and KV caches split over at
        ``tp``: ``tp`` where it divides the heads (``parallel/tp.py`` shards
        the attention block), else 1."""
        return tp if self.motion_num_attention_heads % tp == 0 else 1

    def cache_shapes(
        self, latent_height: int, latent_width: int, num_steps: int, tp: int = 1
    ) -> Tuple[Tuple[int, ...], ...]:
        """Shape of each KV cache, ``[steps, 2, window, C, HW]``, flat
        traversal order; at ``tp`` ranks each rank's, ``C / motion_tp(tp)``
        channels (its heads' slab). Per-level spatial dims follow the
        UNet's stride-2 convs (ceil-halving), not integer division by
        2**level: they differ once an intermediate dim is odd."""
        dims = {1: (latent_height, latent_width)}
        res = 1
        for _ in range(len(self.block_out_channels) - 1):
            h, w = dims[res]
            res *= 2
            dims[res] = (-(-h // 2), -(-w // 2))
        shapes = []
        split = self.motion_tp(tp)
        for channels, res in self.motion_module_layout():
            h, w = dims[res]
            shapes += ([(num_steps, 2, self.window_size, channels // split, h * w)]
                       * self.caches_per_module)
        return tuple(shapes)

    def init_caches(self, latent_height: int, latent_width: int, num_steps: int,
                    dtype=torch.bfloat16, device=None, tp: int = 1) -> Tuple[KVCache, ...]:
        """Zeroed KV caches (each rank's at ``tp``); ``dtype=torch.int8``
        gives (int8 data, f32 per-(slot, channel) scales) pairs: half the
        memory and half the stream-attention read bytes of bf16. The scales
        are per channel, so a rank's slab quantises as the unsharded
        cache's channels do."""
        shapes = self.cache_shapes(latent_height, latent_width, num_steps, tp)
        if dtype == torch.int8:
            return tuple(
                (torch.zeros(s, dtype=torch.int8, device=device),
                 torch.ones((s[0], 2, s[2], s[3]), dtype=torch.float32, device=device))
                for s in shapes
            )
        return tuple(torch.zeros(s, dtype=dtype, device=device) for s in shapes)

    # Reference config keys accepted but fixed to the only behaviour the
    # reference ships; any other value raises.
    _FIXED_KEYS = {
        "use_inflated_groupnorm": (True,),
        "unet_use_temporal_attention": (False,),
        "motion_module_type": ("Streaming", "Vanilla"),
        "temporal_attention_dim_div": (1,),
        "temporal_position_encoding": (True,),
        "zero_initialize": (True,),
        "attention_class_name": ("stream", "versatile"),
    }

    @classmethod
    def _check_keys(cls, section: str, d: dict, known: set) -> None:
        unknown = [k for k in d if k not in known and k not in cls._FIXED_KEYS]
        if unknown:
            raise ValueError(
                f"unknown {section} key(s) {unknown}: not part of the supported "
                f"reference config surface (base_config.yaml); known keys: "
                f"{sorted(known | set(cls._FIXED_KEYS))}"
            )
        for k, allowed in cls._FIXED_KEYS.items():
            if k in d and d[k] not in allowed:
                raise ValueError(f"{section}.{k}={d[k]!r} is unsupported (supported: {allowed}).")

    @classmethod
    def from_reference_config(cls, cfg: dict, **overrides) -> "UNetConfig":
        """Build from a reference-style ``unet_additional_kwargs`` dict;
        unknown keys raise."""
        ua = cfg.get("unet_additional_kwargs", cfg) or {}
        mm = ua.get("motion_module_kwargs", {}) or {}
        ak = mm.get("attention_kwargs", {}) or {}
        if "unet_additional_kwargs" in cfg:
            cls._check_keys("unet_additional_kwargs", ua, {
                "cond_mapping", "use_motion_module", "motion_module_resolutions",
                "motion_module_kwargs", "unet_use_cross_frame_attention",
            })
            cls._check_keys("motion_module_kwargs", mm, {
                "num_attention_heads", "num_transformer_block",
                "attention_block_types", "temporal_position_encoding_max_len",
                "attention_kwargs",
            })
            cls._check_keys("attention_kwargs", ak, {"window_size", "sink_size"})
        kw = dict(
            cond_mapping=ua.get("cond_mapping", True),
            use_motion_module=ua.get("use_motion_module", True),
            motion_module_resolutions=tuple(ua.get("motion_module_resolutions", (1, 2, 4, 8))),
            motion_num_attention_heads=mm.get("num_attention_heads", 8),
            motion_num_transformer_block=mm.get("num_transformer_block", 1),
            motion_attention_block_types=tuple(
                mm.get("attention_block_types", ("Temporal_Self", "Temporal_Self"))
            ),
            motion_pe_max_len=mm.get("temporal_position_encoding_max_len", 24),
            window_size=ak.get("window_size", 16),
            sink_size=ak.get("sink_size", 8),
            unet_use_cross_frame_attention=bool(ua.get("unet_use_cross_frame_attention") or False),
        )
        kw.update(overrides)
        return cls(**kw)


class _Block(nn.Module):
    """A down, mid or up block: its resnets, spatial transformers, motion
    modules and resampler, under the diffusers key names."""

    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()
        self.motion_modules = nn.ModuleList()
        self.downsamplers = nn.ModuleList()
        self.upsamplers = nn.ModuleList()


class UNet3DConditionModel(nn.Module):
    """Depth-conditioned inflated UNet with streaming temporal attention.
    ``kernels`` picks the opt-in kernels of its attention and norm modules."""

    def __init__(self, config: UNetConfig = UNetConfig(),
                 kernels: KernelChoices = DEFAULT_KERNELS):
        super().__init__()
        self.config = cfg = config
        ch = cfg.block_out_channels
        temb = ch[0] * 4
        n = len(ch)

        def resnet(cin, cout):
            return ResnetBlock3D(cin, cout, temb, cfg.norm_num_groups, cfg.norm_eps, kernels)

        def spatial(c):
            return Transformer3DModel(
                c, cfg.attention_head_dim, c // cfg.attention_head_dim,
                cross_attention_dim=cfg.cross_attention_dim,
                cross_frame_attention=cfg.unet_use_cross_frame_attention,
                norm_num_groups=cfg.norm_num_groups, kernels=kernels,
            )

        def motion(c):
            return MotionModule(
                c, cfg.motion_num_attention_heads, cfg.motion_num_transformer_block,
                len(cfg.motion_attention_block_types), cfg.norm_num_groups,
                cfg.motion_pe_max_len, cfg.window_size, kernels=kernels,
            )

        self.conv_in = InflatedConv(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.flow_conv_in = MappingNetwork(ch[0]) if cfg.cond_mapping else None

        # channel bookkeeping of the skip stack, as the forward pass pushes it
        skips = [ch[0]]
        cur = ch[0]
        self.down_blocks = nn.ModuleList()
        for i, block_type in enumerate(cfg.down_block_types):
            blk = _Block()
            has_motion = cfg.use_motion_module and 2**i in cfg.motion_module_resolutions
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(resnet(cur, ch[i]))
                cur = ch[i]
                if block_type == "CrossAttnDownBlock3D":
                    blk.attentions.append(spatial(cur))
                if has_motion:
                    blk.motion_modules.append(motion(cur))
                skips.append(cur)
            if i < n - 1:
                blk.downsamplers.append(Downsample3D(cur))
                skips.append(cur)
            self.down_blocks.append(blk)

        self.mid_block = _Block()
        self.mid_block.resnets.extend([resnet(cur, ch[-1]), resnet(ch[-1], ch[-1])])
        self.mid_block.attentions.append(spatial(ch[-1]))
        cur = ch[-1]

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(ch))
        for i, block_type in enumerate(cfg.up_block_types):
            blk = _Block()
            has_motion = cfg.use_motion_module and 2 ** (n - 1 - i) in cfg.motion_module_resolutions
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(resnet(cur + skips.pop(), rev[i]))
                cur = rev[i]
                if block_type == "CrossAttnUpBlock3D":
                    blk.attentions.append(spatial(cur))
                if has_motion:
                    blk.motion_modules.append(motion(cur))
            if i < n - 1:
                blk.upsamplers.append(Upsample3D(cur))
            self.up_blocks.append(blk)

        self.conv_norm_out = FusedGroupNorm(
            cfg.norm_num_groups, ch[0], cfg.norm_eps, act="silu", site="resnet",
            kernels=kernels,
        )
        self.conv_out = InflatedConv(ch[0], cfg.out_channels, 3, padding=1)

    def forward(
        self,
        sample: torch.Tensor,  # [B, F, h, w, 4]
        timesteps: torch.Tensor,  # [B] int
        encoder_hidden_states: torch.Tensor,  # [B, 77, 768]
        depth_sample: Optional[torch.Tensor],  # [B, F, h, w, 4]
        kv_caches: Sequence[KVCache],
        mode: str = "stream",
        attn_bias: Optional[torch.Tensor] = None,
        pe_idx: Optional[torch.Tensor] = None,
        update_idx: Optional[torch.Tensor] = None,
        warmup_step_idx: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Tuple[KVCache, ...]]:
        cfg = self.config
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0])  # fp32
        emb = self.time_embedding(t_emb.to(sample.dtype))

        sample = self.conv_in(sample)
        if self.flow_conv_in is not None and depth_sample is not None:
            sample = sample + self.flow_conv_in(depth_sample)

        new_caches = list(kv_caches)
        cursor = 0
        cpm = cfg.caches_per_module
        extra = (attn_bias, pe_idx, update_idx, warmup_step_idx)

        def run_motion(x, mm):
            nonlocal cursor
            x, updated = mm(x, new_caches[cursor:cursor + cpm], mode, *extra)
            new_caches[cursor:cursor + cpm] = updated
            cursor += cpm
            return x

        res_stack = [sample]
        for blk in self.down_blocks:
            for l, resnet in enumerate(blk.resnets):
                sample = resnet(sample, emb)
                if len(blk.attentions):
                    sample = blk.attentions[l](sample, encoder_hidden_states)
                if len(blk.motion_modules):
                    sample = run_motion(sample, blk.motion_modules[l])
                res_stack.append(sample)
            for down in blk.downsamplers:
                sample = down(sample)
                res_stack.append(sample)

        sample = self.mid_block.resnets[0](sample, emb)
        sample = self.mid_block.attentions[0](sample, encoder_hidden_states)
        sample = self.mid_block.resnets[1](sample, emb)

        for blk in self.up_blocks:
            for l, resnet in enumerate(blk.resnets):
                sample = resnet(torch.cat([sample, res_stack.pop()], dim=-1), emb)
                if len(blk.attentions):
                    sample = blk.attentions[l](sample, encoder_hidden_states)
                if len(blk.motion_modules):
                    sample = run_motion(sample, blk.motion_modules[l])
            for up in blk.upsamplers:
                # to the next skip's spatial dims (differs from 2x when odd)
                sample = up(sample, output_size=tuple(res_stack[-1].shape[2:4]))

        if cursor != len(new_caches):
            raise RuntimeError(f"cache threading mismatch: used {cursor} of {len(new_caches)}")

        b, f = sample.shape[:2]
        sample = self.conv_norm_out(sample.reshape(b * f, *sample.shape[2:]))
        sample = self.conv_out(sample.reshape(b, f, *sample.shape[1:]))
        return sample, tuple(new_caches)
