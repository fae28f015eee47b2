"""TAESD tiny autoencoder, NHWC, with its 3x3 convs on the fused conv kernel.

Port of the TAESD half of ``live2diff_tpu/models/vae.py`` (``AutoencoderKL``
is a later slice). Module indices follow the madebyollin/taesd
``nn.Sequential`` numbering (``encoder.0``, ``encoder.1.conv.2``, ...,
including the parameter-free Clamp / ReLU / Upsample slots) so a TAESD
state dict loads by name.

Every ``FusedConv3x3`` / ``FusedConv3x3S2`` goes through ``ops.conv.conv3x3``:
on the card that is the hand-written kernel (64 stride-1 and 3 stride-2
launches per stream step at 512x512); the 1x1 skips and the 3-/4-channel
end convs stay ``F.conv2d``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.conv import conv3x3
from .resnet import conv_nhwc


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
        return conv3x3(x, self.weight, self.bias, skip, self.relu, self.stride)


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
