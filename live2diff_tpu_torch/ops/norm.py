"""GroupNorm and LayerNorm with fp32 two-pass (centred) statistics.

Port of ``live2diff_tpu/ops/norm.py``. Each call names its ``site``, and the
sites pick the kernel as the JAX package's defaults do:

* ``layer_norm`` launches the CUDA kernel (``csrc/layer_norm.cu``, replacing
  the Pallas ``_layer_norm_kernel``) on CUDA tensors at ``site="vit"``, the
  DPT's ViT tower (``_LN_TAGS = "vit"``, ``norm.py:56``). The UNet's
  ``spatial`` and ``temporal`` sites run the plain version, as in the JAX
  default; whether the kernel wins there is for a measurement to decide.
* ``group_norm_act`` is plain torch at every site: the JAX package's GroupNorm
  kernel is off everywhere by default (``norm.py:40``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LN_NAME = "layer_norm"
# call sites whose LayerNorm runs the kernel on the card (the JAX default)
LN_KERNEL_SITES = frozenset({"vit"})


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


def layer_norm_plain(
    x: torch.Tensor,  # [..., C]
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the trailing axis, fp32 centred statistics, per row;
    the kernel's plain version. Returns x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * gamma.float() + beta.float()
    return y.to(x.dtype)


def layer_norm_rows(
    x: torch.Tensor,  # [rows, C] bf16
    gamma: torch.Tensor,  # [C] bf16
    beta: torch.Tensor,  # [C] bf16
    eps: float = 1e-5,
) -> torch.Tensor:
    """Row LayerNorm: launches the CUDA kernel on CUDA tensors (bf16,
    contiguous, 16-byte aligned, C % 8 == 0, C <= 1024); a CPU tensor runs
    the plain version."""
    if not x.is_cuda:
        return layer_norm_plain(x, gamma, beta, eps)
    _build.require(x, "x", torch.bfloat16, 2)
    _build.require(gamma, "gamma", torch.bfloat16, 1)
    _build.require(beta, "beta", torch.bfloat16, 1)
    rows, c = x.shape
    if (
        c % 8 or c > 1024 or gamma.shape[0] != c or beta.shape[0] != c
        or any(t.data_ptr() % 16 for t in (x, gamma, beta))
    ):
        raise ValueError(
            f"layer_norm: unsupported x {tuple(x.shape)}, gamma {tuple(gamma.shape)}, "
            f"beta {tuple(beta.shape)} (C % 8 == 0, C <= 1024, 16-byte aligned)"
        )
    out = torch.empty_like(x)
    fn = _build.load("layer_norm").layer_norm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), rows, c,
            float(eps), _build.stream_handle(x))
    _build.check(rc, LN_NAME)
    _build.launch_counts[LN_NAME] += 1
    return out


def layer_norm(
    x: torch.Tensor,  # [..., C]
    gamma: torch.Tensor,
    beta: torch.Tensor,
    eps: float = 1e-5,
    site: str = "",
) -> torch.Tensor:
    """LayerNorm over the trailing axis, fp32 centred statistics, per row:
    the kernel at the kernel sites, the plain version elsewhere."""
    if site not in LN_KERNEL_SITES:
        return layer_norm_plain(x, gamma, beta, eps)
    c = x.shape[-1]
    return layer_norm_rows(x.reshape(-1, c), gamma, beta, eps).reshape(x.shape)
