"""GroupNorm and LayerNorm with fp32 two-pass (centred) statistics.

Port of the plain paths of ``live2diff_tpu/ops/norm.py`` (``group_norm_act``
:150-179, ``layer_norm`` :251-256). The JAX package's Pallas norm kernels
are off at every site of this slice (GroupNorm everywhere, LayerNorm
everywhere but ``site="vit"``), so these are plain torch. ``site`` is kept
so a later kernel can be switched on per call site as in the JAX package.
"""

from __future__ import annotations

import torch


def group_norm_act(
    x: torch.Tensor,  # [B, T, C]
    gamma: torch.Tensor,  # [C]
    beta: torch.Tensor,  # [C]
    groups: int = 32,
    eps: float = 1e-5,
    act: str = "none",
    site: str = "",
) -> torch.Tensor:
    """GroupNorm over [B, T, C] with per-B fp32 statistics, optional SiLU/ReLU.

    The variance is two-pass (centred): E[x^2]-mean^2 cancels in fp32 when
    |mean| >> std, which small groups hit.
    """
    del site
    b, t, c = x.shape
    cg = c // groups
    xf = x.float()
    mean_g = xf.reshape(b, t, groups, cg).mean(dim=(1, 3))  # [B, G]
    mean_c = mean_g.repeat_interleave(cg, dim=-1)  # [B, C]
    xc = xf - mean_c[:, None, :]
    var = (xc * xc).reshape(b, t, groups, cg).mean(dim=(1, 3))
    inv = torch.rsqrt(var + eps)
    scale = inv.repeat_interleave(cg, dim=-1) * gamma.float()
    y = xc * scale[:, None, :] + beta.float()[None, None, :]
    if act == "silu":
        y = torch.nn.functional.silu(y)
    elif act == "relu":
        y = torch.relu(y)
    return y.to(x.dtype)


def layer_norm(
    x: torch.Tensor,  # [..., C]
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-5,
    site: str = "",
) -> torch.Tensor:
    """LayerNorm over the trailing axis, fp32 centred statistics, per row."""
    del site
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * gamma.float() + beta.float()
    return y.to(x.dtype)
