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
  3*2^20``, ``C % groups == 0``, ``C % 8 == 0``) and ``C <= 16384``, the
  widest row the kernel holds; wider calls, which the JAX package sends to
  its kernel, run the plain version: the route differs, the function does
  not. By default there are no such sites (``_GN_TAGS = "none"``,
  ``norm.py:40``). ``group_norm_plan`` cuts a call into the kernel's tiles
  and CTAs; ``gn_route_counts`` counts the launches whose tiles all stay in
  shared memory (``resident``) and the others (``streamed``).

On CPU tensors every wrapper runs its plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Iterator, NamedTuple, Tuple

import torch

from . import _build
from .choices import DEFAULT_KERNELS, KernelChoices

LN_NAME = "layer_norm"
GN_NAME = "group_norm"
# the JAX package's cap on the [T, C] slab its GroupNorm kernel takes
GN_MAX_ELEMS = 3 * 1024 * 1024
# the CUDA GroupNorm kernel's widest row: one row, gamma and beta and the
# statistics' per-channel partials fit a CTA's shared memory
GN_MAX_CHANNELS = 16384
# the JAX package's least LayerNorm input it sends to its kernel
LN_MIN_ELEMS = 1 << 14
# the CUDA LayerNorm kernel's widest row: one block a row, 8 warps, five
# 16-byte vectors a lane
LN_MAX_CHANNELS = 10240
# csrc/group_norm.cu: threads a CTA, tile buffers at most, the bytes its
# mbarriers take at the start of shared memory
_GN_THREADS = 512
_GN_MAX_SLOTS = 8
_GN_BAR_BYTES = 128
# the least x a CTA is worth: below it the launch and the CTAs' meeting
# cost more than the bytes
GN_MIN_TILE_BYTES = 16384

# GroupNorm launches by route: all of a CTA's tiles held in shared memory
# (x read once), or streamed through its buffers and partly read again
gn_route_counts: Dict[str, int] = {"resident": 0, "streamed": 0}


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


def _gn_smem_bytes(c: int, groups: int, slots: int, rows: int) -> int:
    """Dynamic shared memory of a GroupNorm launch, as ``csrc/group_norm.cu:
    smem_bytes`` computes it: the mbarriers, gamma and beta, the float work
    area (the statistics' per-slot partials and group means, then the
    sample's group statistics) and ``slots`` tile buffers of ``rows`` rows."""
    v = c // 8
    work = ((_GN_THREADS // v) * c if v <= _GN_THREADS else c) + groups
    return _GN_BAR_BYTES + 4 * c + -(-4 * work // 16) * 16 + 2 * slots * rows * c


class GroupNormPlan(NamedTuple):
    """How ``csrc/group_norm.cu`` cuts one call: each sample's T rows into
    ``tiles_per_sample`` tiles of whole rows, the ``b * tiles_per_sample``
    tiles into runs of ``tiles_per_cta`` consecutive tiles, one a CTA, with
    ``slots`` tile buffers of ``rows`` rows (the largest tile) in
    ``smem_bytes`` of shared memory. ``resident``: every CTA holds all its
    tiles at once, so x is read once."""

    ctas: int
    tiles_per_sample: int
    tiles_per_cta: int
    rows: int
    slots: int
    smem_bytes: int
    resident: bool

    @property
    def route(self) -> str:
        return "resident" if self.resident else "streamed"

    def tiles(self, b: int, t: int) -> Iterator[Tuple[int, int, int, int]]:
        """(CTA, sample, first row, end row) of every tile, as the kernel
        cuts them (``Cut``: the first t % k tiles of a sample take t // k + 1
        rows, the others t // k)."""
        k = self.tiles_per_sample
        q, r = divmod(t, k)
        for tile in range(b * k):
            s, i = divmod(tile, k)
            first = i * q + min(i, r)
            yield tile // self.tiles_per_cta, s, first, first + q + (i < r)


def group_norm_plan(b: int, t: int, c: int, groups: int, sms: int,
                    smem_bytes: int) -> GroupNormPlan:
    """The grid of one GroupNorm launch over x [b, t, c] on a card with
    ``sms`` SMs and ``smem_bytes`` of shared memory a block may opt into.

    CTAs: at most one an SM, and none with less than GN_MIN_TILE_BYTES of x
    (small slabs get few CTAs). Tiles: a sample's rows are cut into k tiles
    of whole rows, as many as spread the sample over its share of the CTAs;
    where a CTA's share does not fit its shared memory, into more, smaller
    tiles, each CTA taking several in turn with two or more buffers (one
    tile reduced while the next is copied in)."""
    row = 2 * c
    cap = (smem_bytes - _gn_smem_bytes(c, groups, 0, 0)) // row  # rows a CTA holds
    if b < 1 or t < 1 or c % 8 or c % groups or cap < 1:
        raise ValueError(f"group_norm_plan: no plan for x [{b}, {t}, {c}], groups {groups} "
                         f"in {smem_bytes} bytes of shared memory")
    ctas = max(1, min(sms, b * t * row // GN_MIN_TILE_BYTES))
    per_cta = -(-b // ctas)  # tiles a CTA, at least
    while True:
        k = max(1, min(t, ctas * per_cta // b))
        rows = -(-t // k)
        if rows <= (cap if per_cta == 1 else max(1, cap // 2)) or k == t:
            break
        per_cta += 1
    tiles = b * k
    per_cta = -(-tiles // ctas)
    slots = max(1, min(per_cta, _GN_MAX_SLOTS, cap // rows))
    return GroupNormPlan(ctas=-(-tiles // per_cta), tiles_per_sample=k, tiles_per_cta=per_cta,
                         rows=rows, slots=slots,
                         smem_bytes=_gn_smem_bytes(c, groups, slots, rows),
                         resident=per_cta <= slots)


@functools.lru_cache(maxsize=None)
def gn_device_limits(index: int) -> Tuple[int, int]:
    """(SMs, shared memory a block may opt into) of CUDA device ``index``."""
    fn = _build.load("group_norm").group_norm_limits
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    sms, smem = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(fn(index, ctypes.byref(sms), ctypes.byref(smem)), GN_NAME)
    return sms.value, smem.value


def group_norm(
    x: torch.Tensor,  # [B, T, C] bf16
    gamma: torch.Tensor,  # [C] bf16
    beta: torch.Tensor,  # [C] bf16
    groups: int = 32,
    eps: float = 1e-5,
    act: str = "none",
) -> torch.Tensor:
    """GroupNorm(+act): launches the CUDA kernel on CUDA tensors (bf16,
    contiguous, x, gamma and beta 16-byte aligned, C % 8 == 0, C % groups ==
    0, C <= 16384; any B); a CPU tensor runs the plain version."""
    if not x.is_cuda:
        return group_norm_plain(x, gamma, beta, groups, eps, act)
    _build.no_grad_through(GN_NAME, x, gamma, beta)
    _build.require(x, "x", torch.bfloat16, 3)
    _build.require(gamma, "gamma", torch.bfloat16, 1)
    _build.require(beta, "beta", torch.bfloat16, 1)
    b, t, c = x.shape
    if (
        act not in _ACTS or groups < 1 or c % 8 or c % groups or c > GN_MAX_CHANNELS
        or gamma.shape[0] != c or beta.shape[0] != c
        or any(a.data_ptr() % 16 for a in (x, gamma, beta))
    ):
        raise ValueError(
            f"group_norm: unsupported x {tuple(x.shape)}, groups {groups}, act {act!r} "
            f"(C % 8 == 0, C % groups == 0, C <= {GN_MAX_CHANNELS}, 16-byte aligned)"
        )
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    plan = group_norm_plan(b, t, c, groups, *gn_device_limits(x.device.index or 0))
    # (mean, M2) of each (tile, group)
    part = torch.empty(b * plan.tiles_per_sample * groups * 2, dtype=torch.float32,
                       device=x.device)
    fn = _build.load("group_norm").group_norm
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), part.data_ptr(),
            b, t, c, groups, plan.tiles_per_sample, plan.tiles_per_cta, plan.slots, plan.ctas,
            _ACTS[act], float(eps), _build.stream_handle(x))
    _build.check(rc, GN_NAME)
    _build.launch_counts[GN_NAME] += 1
    gn_route_counts[plan.route] += 1
    return out


def _aligned(a: torch.Tensor) -> torch.Tensor:
    """``a`` contiguous and starting on 16 bytes, as the GroupNorm kernel's
    copies need (a view that starts elsewhere is copied)."""
    a = a.contiguous()
    return a if a.data_ptr() % 16 == 0 else a.clone()


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
    package's conditions hold and C fits the kernel (C <= GN_MAX_CHANNELS),
    the plain version elsewhere. Decided from the shape before any launch.
    gamma and beta may be stored in another dtype than x (``param_dtype``):
    the plain version applies them in fp32 as they are, the kernel, which
    takes them in x's dtype, after a cast."""
    _, t, c = x.shape
    if (
        kernels.gn_kernel_at(site) and t * c <= GN_MAX_ELEMS and c % groups == 0
        and c % 8 == 0 and c <= GN_MAX_CHANNELS
    ):
        gamma, beta = gamma.to(x.dtype), beta.to(x.dtype)
        return group_norm(*map(_aligned, (x, gamma, beta)), groups, eps, act)
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
    _build.no_grad_through(LN_NAME, x, gamma, beta)
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
    elsewhere. gamma and beta in another dtype than x: as ``group_norm_act``."""
    c = x.shape[-1]
    if not (kernels.ln_kernel_at(site) and c % 8 == 0 and x.numel() >= LN_MIN_ELEMS):
        return layer_norm_plain(x, gamma, beta, eps)
    gamma, beta = gamma.to(x.dtype), beta.to(x.dtype)
    return layer_norm_rows(x.reshape(-1, c).contiguous(), gamma, beta, eps).reshape(x.shape)
