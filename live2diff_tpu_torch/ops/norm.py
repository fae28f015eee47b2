"""GroupNorm and LayerNorm with fp32 two-pass (centred) statistics.

Port of ``live2diff_tpu/ops/norm.py``. Each call names its ``site``, and a
``KernelChoices`` (``ops/choices.py``) says at which sites the kernel runs;
the defaults are the JAX package's:

* ``layer_norm`` launches the CUDA kernel (``csrc/layer_norm.cu``, replacing
  the Pallas ``_layer_norm_kernel``) at the LayerNorm kernel sites, by
  default ``vit``, the DPT's ViT tower (``_LN_TAGS = "vit"``, ``norm.py:56``),
  where the JAX package's shape conditions hold (``norm.py:239-246``: ``C %
  8 == 0`` and at least ``2^14`` elements). The UNet's ``spatial`` and
  ``temporal`` sites run the plain version unless chosen.
* ``group_norm_act`` launches the CUDA kernel (``csrc/group_norm.cu``,
  replacing the Pallas ``_group_norm_kernel``) at the GroupNorm kernel sites
  when the JAX package's conditions hold (``norm.py:140-147``: ``T*C <=
  3*2^20``, ``C % groups == 0``, ``C % 8 == 0``). By default there are no
  such sites (``_GN_TAGS = "none"``, ``norm.py:40``).

On CPU tensors every wrapper runs its plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .choices import DEFAULT_KERNELS, KernelChoices

LN_NAME = "layer_norm"
GN_NAME = "group_norm"
# the JAX package's cap on the [T, C] slab its GroupNorm kernel takes
GN_MAX_ELEMS = 3 * 1024 * 1024
# the CUDA GroupNorm kernel's limits (its per-channel shared-memory tables
# and one thread per group): the UNet's widest GroupNorm is the 2560
# channels of an up block's concatenated skip
GN_MAX_CHANNELS = 3072
GN_MAX_GROUPS = 256
# the JAX package's least LayerNorm input it sends to its kernel
LN_MIN_ELEMS = 1 << 14
# the CUDA LayerNorm kernel's widest row: one block a row, 8 warps, five
# 16-byte vectors a lane
LN_MAX_CHANNELS = 10240
# blocks the GroupNorm kernel aims for: two per SM of an H100
_GN_TARGET_BLOCKS = 264


def group_norm_plain(
    x: torch.Tensor,  # [B, T, C]
    gamma: torch.Tensor,  # [C]
    beta: torch.Tensor,  # [C]
    groups: int = 32,
    eps: float = 1e-5,
    act: str = "none",
) -> torch.Tensor:
    """GroupNorm over [B, T, C] with per-B fp32 statistics, optional SiLU/ReLU;
    the kernel's plain version.

    The variance is two-pass (centred): E[x^2]-mean^2 cancels in fp32 when
    |mean| >> std, which small groups hit.
    """
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


_ACTS = {"none": 0, "silu": 1, "relu": 2}


def group_norm(
    x: torch.Tensor,  # [B, T, C] bf16
    gamma: torch.Tensor,  # [C] bf16
    beta: torch.Tensor,  # [C] bf16
    groups: int = 32,
    eps: float = 1e-5,
    act: str = "none",
) -> torch.Tensor:
    """GroupNorm(+act): launches the CUDA kernel on CUDA tensors (bf16,
    contiguous, 16-byte aligned, C % 8 == 0, C % groups == 0, C <= 3072,
    groups <= 256); a CPU tensor runs the plain version."""
    if not x.is_cuda:
        return group_norm_plain(x, gamma, beta, groups, eps, act)
    _build.require(x, "x", torch.bfloat16, 3)
    _build.require(gamma, "gamma", torch.bfloat16, 1)
    _build.require(beta, "beta", torch.bfloat16, 1)
    b, t, c = x.shape
    if (
        act not in _ACTS or c % 8 or c % groups or c > GN_MAX_CHANNELS or groups > GN_MAX_GROUPS
        or gamma.shape[0] != c or beta.shape[0] != c or x.data_ptr() % 16 or t == 0
        or b > 65535
    ):
        raise ValueError(
            f"group_norm: unsupported x {tuple(x.shape)}, groups {groups}, act {act!r} "
            f"(C % 8 == 0, C % groups == 0, C <= {GN_MAX_CHANNELS}, groups <= {GN_MAX_GROUPS})"
        )
    # rows per block: enough blocks to fill the card, at least one row each
    per_sample = max(1, -(-_GN_TARGET_BLOCKS // b))
    rows = -(-t // per_sample)
    chunks = -(-t // rows)
    stats = torch.empty(b * chunks * groups * 2, dtype=torch.float32, device=x.device)
    mean_rstd = torch.empty(b * groups * 2, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    fn = _build.load("group_norm").group_norm
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            stats.data_ptr(), mean_rstd.data_ptr(), b, t, c, groups, rows, _ACTS[act],
            float(eps), _build.stream_handle(x))
    _build.check(rc, GN_NAME)
    _build.launch_counts[GN_NAME] += 1
    return out


def group_norm_act(
    x: torch.Tensor,  # [B, T, C]
    gamma: torch.Tensor,  # [C]
    beta: torch.Tensor,  # [C]
    groups: int = 32,
    eps: float = 1e-5,
    act: str = "none",
    site: str = "",
    kernels: KernelChoices = DEFAULT_KERNELS,
) -> torch.Tensor:
    """GroupNorm over [B, T, C] with per-B fp32 statistics, optional
    SiLU/ReLU: the kernel at the GroupNorm kernel sites where the JAX
    package's conditions hold, the plain version elsewhere."""
    _, t, c = x.shape
    if (
        kernels.gn_kernel_at(site) and t * c <= GN_MAX_ELEMS and c % groups == 0
        and c % 8 == 0
    ):
        return group_norm(x.contiguous(), gamma, beta, groups, eps, act)
    return group_norm_plain(x, gamma, beta, groups, eps, act)


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
    contiguous, 16-byte aligned, C % 8 == 0, C <= 10240: one warp a row up
    to C = 1280, one block a row above); a CPU tensor runs the plain
    version."""
    if not x.is_cuda:
        return layer_norm_plain(x, gamma, beta, eps)
    _build.require(x, "x", torch.bfloat16, 2)
    _build.require(gamma, "gamma", torch.bfloat16, 1)
    _build.require(beta, "beta", torch.bfloat16, 1)
    rows, c = x.shape
    if (
        c % 8 or c > LN_MAX_CHANNELS or gamma.shape[0] != c or beta.shape[0] != c
        or any(t.data_ptr() % 16 for t in (x, gamma, beta))
    ):
        raise ValueError(
            f"layer_norm: unsupported x {tuple(x.shape)}, gamma {tuple(gamma.shape)}, "
            f"beta {tuple(beta.shape)} (C % 8 == 0, C <= {LN_MAX_CHANNELS}, 16-byte aligned)"
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
    kernels: KernelChoices = DEFAULT_KERNELS,
) -> torch.Tensor:
    """LayerNorm over the trailing axis, fp32 centred statistics, per row:
    the kernel at the LayerNorm kernel sites where the JAX package's shape
    conditions hold (C % 8 == 0, at least 2^14 elements), the plain version
    elsewhere."""
    c = x.shape[-1]
    if not (kernels.ln_kernel_at(site) and c % 8 == 0 and x.numel() >= LN_MIN_ELEMS):
        return layer_norm_plain(x, gamma, beta, eps)
    return layer_norm_rows(x.reshape(-1, c).contiguous(), gamma, beta, eps).reshape(x.shape)
