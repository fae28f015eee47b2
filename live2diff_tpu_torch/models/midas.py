"""MiDaS DPT-hybrid depth estimator (``vitb_rn50_384``), channels-last.

Port of ``live2diff_tpu/models/midas.py``: a BiT ResNetV2-50 stem and three
stages (weight-standardised convs, GroupNorm + ReLU) feeding a ViT-B/16 over
the 24x24 patch grid; four taps (ResNet stages 1 and 2, two ViT blocks)
reassembled and fused RefineNet-style into a 384x384 inverse-depth map with
a non-negative head. Activations are ``[B, H, W, C]``.

Submodules carry the names of the MiDaS checkpoint ``dpt_hybrid_384.pt``
(timm's ``vit_base_r50_s16_384`` under ``pretrained.model``, the DPT decoder
under ``scratch``), the keys ``live2diff_tpu/convert/midas.py`` maps from, so
that checkpoint loads by name. The one exception is ``refinenet4``'s first
residual unit, which the model never calls and so does not hold.

The ViT's LayerNorms are ``site="vit"`` and the GroupNorms ``site="midas"``
(each norm's kernel on the card by default, where its input allows:
``ops/norm.py``), its attention goes through
``ops.attention.dot_product_attention`` (the flash kernel on the card); every
convolution is ``F.conv2d``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.choices import DEFAULT_KERNELS, KernelChoices
from .layers import FusedGroupNorm, FusedLayerNorm
from .resnet import conv_nhwc


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    image_size: int = 384
    patch_grid: int = 24  # 384 / 16
    vit_hidden: int = 768
    vit_layers: int = 12
    vit_heads: int = 12
    vit_mlp: int = 3072
    hooks: Tuple[int, int] = (8, 11)  # ViT blocks tapped (0-based)
    resnet_layers: Tuple[int, int, int] = (3, 4, 9)
    features: int = 256
    non_negative: bool = True


STAGE_CHANNELS = (256, 512, 1024)
REASSEMBLE_CHANNELS = 768  # the readout projections' width, fixed by the DPT


def resize_nhwc(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of ``[N, H, W, C]`` in fp32 (half-pixel centres, no
    antialiasing, as ``jax.image.resize(..., "bilinear", antialias=False)``
    and, for upsampling, its default), cast back to x's dtype."""
    out = F.interpolate(x.float().permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                        align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1).to(x.dtype)


class StdConv(nn.Conv2d):
    """Weight-standardised conv (BiT): each output channel's kernel is
    standardised over (in, kh, kw) in fp32 (population variance, eps 1e-8
    inside the square root), then cast to the compute dtype. NHWC."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.float()
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), keepdim=True, unbiased=False)
        w = ((w - mean) / torch.sqrt(var + 1e-8)).to(x.dtype)
        out = F.conv2d(x.permute(0, 3, 1, 2), w, self.bias, self.stride, self.padding)
        return out.permute(0, 2, 3, 1)


class GNReLU(FusedGroupNorm):
    """GroupNorm(32) + ReLU over NHWC, per-sample statistics."""

    def __init__(self, channels: int, groups: int = 32, kernels: KernelChoices = DEFAULT_KERNELS):
        super().__init__(groups, channels, eps=1e-5, act="relu", site="midas", kernels=kernels)


class _Downsample(nn.Module):
    """The bottleneck's projection shortcut: 1x1 StdConv + GroupNorm."""

    def __init__(self, cin: int, cout: int, stride: int, kernels: KernelChoices):
        super().__init__()
        self.conv = StdConv(cin, cout, 1, stride, 0, bias=False)
        self.norm = FusedGroupNorm(32, cout, eps=1e-5, site="midas", kernels=kernels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class ResNetV2Bottleneck(nn.Module):
    """Non-preact BiT bottleneck: StdConv+GN(+ReLU) x3, GN'd projection shortcut."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 kernels: KernelChoices = DEFAULT_KERNELS):
        super().__init__()
        mid = out_channels // 4
        self.downsample = (_Downsample(in_channels, out_channels, stride, kernels)
                           if in_channels != out_channels or stride != 1 else None)
        self.conv1 = StdConv(in_channels, mid, 1, bias=False)
        self.norm1 = GNReLU(mid, kernels=kernels)
        self.conv2 = StdConv(mid, mid, 3, stride, 1, bias=False)
        self.norm2 = GNReLU(mid, kernels=kernels)
        self.conv3 = StdConv(mid, out_channels, 1, bias=False)
        self.norm3 = FusedGroupNorm(32, out_channels, eps=1e-5, site="midas", kernels=kernels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.downsample is None else self.downsample(x)
        h = self.norm1(self.conv1(x))
        h = self.norm2(self.conv2(h))
        h = self.norm3(self.conv3(h))
        return torch.relu(h + shortcut)


class _SelfAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.proj = nn.Linear(hidden, hidden)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        dh = h.shape[-1] // self.heads
        q, k, v = (t.reshape(*t.shape[:-1], self.heads, dh) for t in self.qkv(h).chunk(3, -1))
        return self.proj(dot_product_attention(q, k, v).reshape(h.shape))


class _Mlp(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, hidden)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(h), approximate="none"))


class ViTBlock(nn.Module):
    """Pre-norm ViT block: LN -> MHSA -> +x, LN -> MLP (exact GELU) -> +x."""

    def __init__(self, hidden: int, heads: int, mlp_dim: int,
                 kernels: KernelChoices = DEFAULT_KERNELS):
        super().__init__()
        self.norm1 = FusedLayerNorm(hidden, eps=1e-6, site="vit", kernels=kernels)
        self.attn = _SelfAttention(hidden, heads)
        self.norm2 = FusedLayerNorm(hidden, eps=1e-6, site="vit", kernels=kernels)
        self.mlp = _Mlp(hidden, mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ResidualConvUnit(nn.Module):
    """relu-conv-relu-conv residual unit (DPT scratch, bn=False)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv_nhwc(torch.relu(x), self.conv1)
        return x + conv_nhwc(torch.relu(h), self.conv2)


class FeatureFusionBlock(nn.Module):
    """RefineNet-style fusion: (skip through resConfUnit1) + resConfUnit2,
    2x bilinear upsample, 1x1 projection."""

    def __init__(self, features: int, has_skip: bool = True):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features) if has_skip else None
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = resize_nhwc(x, x.shape[1] * 2, x.shape[2] * 2)
        return conv_nhwc(x, self.out_conv)


class _Stem(nn.Module):
    def __init__(self, kernels: KernelChoices):
        super().__init__()
        self.conv = StdConv(3, 64, 7, 2, 3, bias=False)
        self.norm = GNReLU(64, kernels=kernels)


class _Stage(nn.Module):
    def __init__(self, cin: int, cout: int, n_blocks: int, stride: int, kernels: KernelChoices):
        super().__init__()
        self.blocks = nn.ModuleList([
            ResNetV2Bottleneck(cin if i == 0 else cout, cout, stride if i == 0 else 1, kernels)
            for i in range(n_blocks)
        ])


class _Backbone(nn.Module):
    def __init__(self, cfg: DPTConfig, kernels: KernelChoices):
        super().__init__()
        self.stem = _Stem(kernels)
        cins = (64,) + STAGE_CHANNELS[:-1]
        self.stages = nn.ModuleList([
            _Stage(cin, cout, n, 1 if s == 0 else 2, kernels)
            for s, (cin, cout, n) in enumerate(zip(cins, STAGE_CHANNELS, cfg.resnet_layers))
        ])


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: DPTConfig, kernels: KernelChoices):
        super().__init__()
        self.backbone = _Backbone(cfg, kernels)
        self.proj = nn.Conv2d(STAGE_CHANNELS[-1], cfg.vit_hidden, 1)


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: DPTConfig, kernels: KernelChoices):
        super().__init__()
        g, d = cfg.patch_grid, cfg.vit_hidden
        self.patch_embed = _PatchEmbed(cfg, kernels)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, g * g + 1, d))
        self.blocks = nn.ModuleList([
            ViTBlock(d, cfg.vit_heads, cfg.vit_mlp, kernels) for _ in range(cfg.vit_layers)
        ])


class _ProjectReadout(nn.Module):
    """'project' readout: each patch token concatenated with the cls token
    (in that order), Linear, exact GELU."""

    def __init__(self, hidden: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * hidden, hidden), nn.GELU())

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        patch = t[:, 1:]
        return self.project(torch.cat([patch, t[:, :1].expand_as(patch)], dim=-1))


def _reassemble(hidden: int, down: bool) -> nn.ModuleList:
    """``act_postprocess{3,4}``: slot 0 the readout, 3 the 1x1 projection,
    4 (tap 4 only) the stride-2 3x3 conv; the empty slots are MiDaS's
    transpose / unflatten."""
    slots = [_ProjectReadout(hidden), nn.Identity(), nn.Identity(),
             nn.Conv2d(hidden, REASSEMBLE_CHANNELS, 1)]
    if down:
        slots.append(nn.Conv2d(REASSEMBLE_CHANNELS, REASSEMBLE_CHANNELS, 3, stride=2, padding=1))
    return nn.ModuleList(slots)


class _Pretrained(nn.Module):
    def __init__(self, cfg: DPTConfig, kernels: KernelChoices):
        super().__init__()
        self.model = _VisionTransformer(cfg, kernels)
        self.act_postprocess3 = _reassemble(cfg.vit_hidden, down=False)
        self.act_postprocess4 = _reassemble(cfg.vit_hidden, down=True)


class _Scratch(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        f = cfg.features
        taps = (STAGE_CHANNELS[0], STAGE_CHANNELS[1], REASSEMBLE_CHANNELS, REASSEMBLE_CHANNELS)
        for i, cin in enumerate(taps, start=1):
            setattr(self, f"layer{i}_rn", nn.Conv2d(cin, f, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(f, has_skip=i < 4))
        # slots 1, 3, 5: MiDaS's Interpolate and ReLUs
        self.output_conv = nn.ModuleList([
            nn.Conv2d(f, f // 2, 3, padding=1), nn.Identity(),
            nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1), nn.ReLU() if cfg.non_negative else nn.Identity(),
        ])


class DPTDepthModel(nn.Module):
    """vitb_rn50_384 hybrid DPT depth model: [B, 384, 384, 3] -> [B, 384, 384].
    ``kernels`` picks the norm kernels of its GroupNorm and LayerNorm sites."""

    def __init__(self, config: DPTConfig = DPTConfig(),
                 kernels: KernelChoices = DEFAULT_KERNELS):
        super().__init__()
        self.config = config
        self.pretrained = _Pretrained(config, kernels)
        self.scratch = _Scratch(config)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, g, d = x.shape[0], cfg.patch_grid, cfg.vit_hidden
        vit = self.pretrained.model
        backbone = vit.patch_embed.backbone

        # --- ResNetV2-50 stem (/4): -inf padding, 3x3 stride-2 max pool ---
        h = backbone.stem.norm(backbone.stem.conv(x))
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)

        # --- stages (taps after stages 1 and 2) ---
        taps = []
        for s, stage in enumerate(backbone.stages):
            for block in stage.blocks:
                h = block(h)
            if s < 2:
                taps.append(h)  # 96x96x256, 48x48x512
        layer1, layer2 = taps

        # --- ViT over the patch grid ---
        tokens = conv_nhwc(h, vit.patch_embed.proj).reshape(b, g * g, d)
        tokens = torch.cat([vit.cls_token.expand(b, 1, d), tokens], dim=1) + vit.pos_embed
        vit_taps = {}
        for i, block in enumerate(vit.blocks):
            tokens = block(tokens)
            if i in cfg.hooks:
                vit_taps[i] = tokens

        post3, post4 = self.pretrained.act_postprocess3, self.pretrained.act_postprocess4
        layer3 = post3[0](vit_taps[cfg.hooks[0]]).reshape(b, g, g, d)
        layer3 = conv_nhwc(layer3, post3[3])  # 24x24x768
        layer4 = post4[0](vit_taps[cfg.hooks[1]]).reshape(b, g, g, d)
        layer4 = conv_nhwc(conv_nhwc(layer4, post4[3]), post4[4])  # 12x12x768

        # --- scratch: project the taps to `features`, fuse coarse -> fine ---
        sc = self.scratch
        l1, l2 = conv_nhwc(layer1, sc.layer1_rn), conv_nhwc(layer2, sc.layer2_rn)
        l3, l4 = conv_nhwc(layer3, sc.layer3_rn), conv_nhwc(layer4, sc.layer4_rn)
        path = sc.refinenet4(l4)
        path = sc.refinenet3(path, l3)
        path = sc.refinenet2(path, l2)
        path = sc.refinenet1(path, l1)

        # --- head ---
        out = sc.output_conv
        h = conv_nhwc(path, out[0])
        h = resize_nhwc(h, h.shape[1] * 2, h.shape[2] * 2)
        h = torch.relu(conv_nhwc(h, out[2]))
        h = out[5](conv_nhwc(h, out[4]))
        return h[..., 0]


# MiDaS's normalisation for dpt_hybrid: (x - 0.5) / 0.5 on [0, 1] input
MIDAS_MEAN = (0.5, 0.5, 0.5)
MIDAS_STD = (0.5, 0.5, 0.5)


def midas_preprocess(frames_rgb_m1_1: torch.Tensor) -> torch.Tensor:
    """The stream feeds [-1, 1] frames straight into the depth model at
    384x384; MiDaS's own normalisation maps [0, 1] onto the same range, so
    this is the identity, kept to document the input contract."""
    return frames_rgb_m1_1
