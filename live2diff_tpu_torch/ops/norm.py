"""GroupNorm and LayerNorm with fp32 two-pass (centred) statistics.

Port of ``live2diff_tpu/ops/norm.py``. Each call names its ``site``, and a
``KernelChoices`` (``ops/choices.py``) says at which sites the kernel may
run. The port's default is every site, where the JAX package's is none for
GroupNorm (``_GN_TAGS = "none"``, ``norm.py:40``) and ``vit`` for LayerNorm
(``_LN_TAGS = "vit"``, ``norm.py:56``): on an H100 the plain versions'
eleven or twelve library launches a call (casts, broadcast arithmetic, two
``mean`` reductions) made up most of the 40-46 % of a stream call's device
time that PyTorch's elementwise and reduction kernels took, and each kernel
does a call in one launch (``ops/choices.py`` gives the measured gain).

Which implementation a call takes is decided from what the call can
observe, by ``gn_route`` and ``ln_route`` (pure functions of the shape,
dtype, device type, gradient need, site, choices and, for GroupNorm, the
card's shared memory):

* the kernel where x is a bf16 CUDA tensor, no gradient is needed through
  the call, the pipeline's choices name the site and the shape conditions
  hold: for ``group_norm_act`` (``csrc/group_norm.cu``, replacing the
  Pallas ``_group_norm_kernel``) ``C % groups == 0``, ``C % 8 == 0`` (the
  JAX package's, ``norm.py:140-147``), ``C <= 16384`` and a plan
  (``group_norm_plan``: a row of C fits a CTA's shared memory beside gamma,
  beta and the work area); for ``layer_norm`` (``csrc/layer_norm.cu``,
  replacing the Pallas ``_layer_norm_kernel``) the JAX package's
  (``norm.py:239-246``: ``C % 8 == 0`` and at least ``2^14`` elements) and
  ``C <= 10240``;
* the plain version, the same function in PyTorch ops, everywhere else:
  CPU tensors, fp32 pipelines, training with gradients, rows too wide. The
  route differs, the function does not.

The JAX package also caps the GroupNorm slab at ``T*C <= 3*2^20``: its
Pallas kernel holds a whole ``[T, C]`` sample in VMEM. The CUDA kernel cuts
a sample into tiles of whole rows and streams the tiles through shared
memory where they do not all fit, so the port has no such cap: the UNet's
``[2, 4096, 960]``, prepare's 8-frame slabs and the KL codec's GroupNorms
(to ``[2, 262144, 128]`` at 512x512) take the kernel.

``norm_route_counts`` counts the calls by norm and route where the route
is decided, so a captured step's replays add nothing. ``group_norm_plan``
cuts a kernel call into tiles and CTAs; ``gn_route_counts`` counts the
launches whose tiles all stay in shared memory (``resident``) and the
others (``streamed``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from . import _build
from .choices import DEFAULT_KERNELS, KernelChoices

LN_NAME = "layer_norm"
GN_NAME = "group_norm"
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
# norm calls by norm and route (``gn_route``, ``ln_route``), counted where
# the route is decided: at eager calls and at capture, never at a replay
norm_route_counts: Dict[str, int] = {"gn_kernel": 0, "gn_plain": 0, "ln_kernel": 0,
                                     "ln_plain": 0}


def gn_route(t: int, c: int, groups: int, dtype: torch.dtype, device_type: str, grad: bool,
             site: str, kernels: KernelChoices, smem_bytes: Optional[int] = None,
             device_index: int = 0) -> str:
    """``"gn_kernel"`` or ``"gn_plain"``: where ``group_norm_act`` sends a
    call on x ``[B, t, c]`` in ``dtype`` (see the module's docstring).
    ``smem_bytes``: the shared memory a block may opt into on the card; None
    reads card ``device_index``'s, once every other condition holds."""
    if (
        device_type != "cuda" or dtype != torch.bfloat16 or grad
        or not kernels.gn_kernel_at(site) or c % groups or c % 8 or c > GN_MAX_CHANNELS
    ):
        return "gn_plain"
    if smem_bytes is None:
        smem_bytes = gn_device_limits(device_index)[1]
    return "gn_kernel" if t >= 1 and _gn_cta_rows(c, groups, smem_bytes) >= 1 else "gn_plain"


def ln_route(numel: int, c: int, dtype: torch.dtype, device_type: str, grad: bool,
             site: str, kernels: KernelChoices) -> str:
    """``"ln_kernel"`` or ``"ln_plain"``: where ``layer_norm`` sends a call
    on x ``[..., c]`` of ``numel`` elements (see the module's docstring)."""
    if (
        device_type == "cuda" and dtype == torch.bfloat16 and not grad
        and kernels.ln_kernel_at(site) and c % 8 == 0 and numel >= LN_MIN_ELEMS
        and c <= LN_MAX_CHANNELS
    ):
        return "ln_kernel"
    return "ln_plain"


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
    mean_g = _group_mean(xf.reshape(b, t, groups, cg))  # [B, G]
    mean_c = mean_g.repeat_interleave(cg, dim=-1)  # [B, C]
    xc = xf - mean_c[:, None, :]
    var = _group_mean((xc * xc).reshape(b, t, groups, cg))
    inv = torch.rsqrt(var + eps)
    scale = inv.repeat_interleave(cg, dim=-1) * gamma.float()
    y = xc * scale[:, None, :] + beta.float()[None, None, :]
    if act == "silu":
        y = torch.nn.functional.silu(y)
    elif act == "relu":
        y = torch.relu(y)
    return y.to(x.dtype)


def _group_mean(x: torch.Tensor) -> torch.Tensor:
    """[B, T, G, Cg] fp32 -> its mean over T and Cg, [B, G] fp32. The CPU
    sums a strided T axis in order, which in fp32 left 5e-5 of relative
    error in the DPT stem's GroupNorm (73,728-element groups); it sums in
    fp64 there, which also keeps the mean of a group the same whichever
    order the CPU's threads take (a tp rank's slab of groups against the
    whole). CUDA reduces in a tree, in fp32."""
    if x.is_cuda:
        return x.mean(dim=(1, 3))
    # T first: the CPU sums a strided pair of axes many times slower
    sums = x.sum(dim=1, dtype=torch.float64).sum(dim=-1)
    return (sums / (x.shape[1] * x.shape[3])).float()


_ACTS = {"none": 0, "silu": 1, "relu": 2}


def _gn_smem_bytes(c: int, groups: int, slots: int, rows: int) -> int:
    """Dynamic shared memory of a GroupNorm launch, as ``csrc/group_norm.cu:
    smem_bytes`` computes it: the mbarriers, gamma and beta, the float work
    area (the statistics' per-slot partials and group means, then the
    sample's group statistics) and ``slots`` tile buffers of ``rows`` rows."""
    v = c // 8
    work = ((_GN_THREADS // v) * c if v <= _GN_THREADS else c) + groups
    return _GN_BAR_BYTES + 4 * c + -(-4 * work // 16) * 16 + 2 * slots * rows * c


def _gn_cta_rows(c: int, groups: int, smem_bytes: int) -> int:
    """Rows of C a CTA can hold in ``smem_bytes`` of shared memory beside the
    mbarriers, gamma, beta and the work area: a kernel call on rows of C has
    a plan (``group_norm_plan``) where this is at least 1."""
    return (smem_bytes - _gn_smem_bytes(c, groups, 0, 0)) // (2 * c)


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
    cap = _gn_cta_rows(c, groups, smem_bytes)  # rows a CTA holds
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
    SiLU/ReLU: the kernel where ``gn_route`` says so, the plain version
    elsewhere; decided before any launch."""
    _, t, c = x.shape
    route = gn_route(t, c, groups, x.dtype, x.device.type, _build.needs_grad(x, gamma, beta),
                     site, kernels, device_index=x.device.index or 0)
    norm_route_counts[route] += 1
    if route == "gn_kernel":
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
    the kernel where ``ln_route`` says so, the plain version elsewhere."""
    c = x.shape[-1]
    grad = _build.needs_grad(x, gamma, beta)
    route = ln_route(x.numel(), c, x.dtype, x.device.type, grad, site, kernels)
    norm_route_counts[route] += 1
    if route == "ln_plain":
        return layer_norm_plain(x, gamma, beta, eps)
    return layer_norm_rows(x.reshape(-1, c).contiguous(), gamma, beta, eps).reshape(x.shape)
