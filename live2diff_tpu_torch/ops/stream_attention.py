"""Stream window attention over the KV cache: kernel wrappers and plain version.

The hot per-frame op of the motion modules: each (step, spatial position,
head) attends over its own 16-slot temporal window of the cache. One CUDA
kernel template (``csrc/stream_attention.cu``) replaces both Pallas TPU
kernels of ``live2diff_tpu/ops/stream_attention.py``:
``stream_window_attention_int8`` the int8-cache one
(``stream_window_attention_kernel_int8``), ``stream_window_attention_bf16``
the bf16-cache one (``stream_window_attention_kernel``).
``stream_window_attention_plain`` computes the same function in plain
torch, as the JAX package's non-TPU path does (``ops/attention.py:220-243``).

Math, with the positional encodings factored out of the cache:

    logits = scale * q_full . (k * k_scale)  +  extra
    probs  = softmax over the window (fp32)
    out    = probs . (v * v_scale + pe_v)

(no scales for a float cache). ``extra`` = scale * q_full . pe_k +
visibility bias, computed by the caller.

Each launch takes a route that ``plan`` picks from the shape: the staging
of the cache (``tma``, TMA boxes, where a channel row of HW elements is a
multiple of 16 bytes; ``scalar``, element loads, elsewhere)
and the cluster size (the CTAs that share one tile's channels, so that the
small latent levels still fill the card). ``route_counts`` counts the
launches of each route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from . import _build

NAME_INT8 = "stream_attention_int8"
NAME_BF16 = "stream_attention_bf16"

WINDOW = 16
# channels a stage of the kernel holds; the cluster splits a head by them
CHUNK = 8
MAX_CLUSTER = 8
# the widest channel share a CTA takes (shared memory: the staging ring,
# the logit tiles and, per channel, its tables and q / out row)
MAX_CHANNELS_PER_CTA = {1: 320, 2: 784}

# launches by staging route, and those of them that ran as a cluster
route_counts: Dict[str, int] = {"tma": 0, "scalar": 0, "cluster": 0}


def plan(steps: int, hw: int, c: int, heads: int, elem_bytes: int, sms: int = 132,
         aligned: bool = True) -> Tuple[str, int]:
    """(staging, cluster) of a launch. A CTA owns 128 bytes of positions of
    one (step, head); where those CTAs are fewer than the SMs, the head's
    8-channel chunks are split over a cluster of up to 8 CTAs: the fewest
    that fill the SMs, then the fewest that keep the same most chunks a CTA
    (so that the CTAs' shares are as even as they can be). ``aligned``: the
    cache's data starts on 16 bytes."""
    dh = c // heads
    chunks = -(-dh // CHUNK)
    ctas = steps * heads * -(-hw // (128 // elem_bytes))
    widest = min(MAX_CLUSTER, chunks)
    cluster = next((k for k in range(1, widest + 1) if ctas * k >= sms), widest)
    cluster = min(k for k in range(1, cluster + 1) if -(-chunks // k) == -(-chunks // cluster))
    while -(-chunks // cluster) * CHUNK > MAX_CHANNELS_PER_CTA[elem_bytes]:
        if cluster == widest:
            raise ValueError(f"stream attention: head width {dh} is too wide for the kernel")
        cluster += 1
    staging = "tma" if aligned and hw * elem_bytes % 16 == 0 else "scalar"
    return staging, cluster


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_window_attention_plain(
    q_full: torch.Tensor,  # [s, HW, C]
    cache_data: torch.Tensor,  # [s, 2, window, C, HW] int8 or float
    scales: Optional[torch.Tensor],  # [s, 2, window, C] f32, None for a float cache
    extra: torch.Tensor,  # [s, window, heads, HW] f32
    pe_v: torch.Tensor,  # [s, window, C]
    scale: float,
    heads: int,
) -> torch.Tensor:
    """Plain torch version of the kernel: the dequantised cache in q's dtype,
    products with fp32 accumulation, probabilities cast to q's dtype before
    the value product. Runs wherever its tensors lie; with TF32 off it is
    the kernel's reference on the card. Returns [s, HW, C] in q's dtype."""
    s, hw, c = q_full.shape
    window = cache_data.shape[2]
    dh = c // heads
    dt = q_full.dtype
    if scales is not None:
        dq = cache_data.float() * scales.float()[..., None]
        kch, vch = dq[:, 0].to(dt), dq[:, 1].to(dt)
    else:
        kch, vch = cache_data[:, 0].to(dt), cache_data[:, 1].to(dt)
    kch = kch.reshape(s, window, heads, dh, hw).float()
    vch = vch.reshape(s, window, heads, dh, hw).float()
    qh = q_full.reshape(s, hw, heads, dh).float()
    logits = torch.einsum("sphd,swhdp->swhp", qh, kch) * scale + extra.float()
    probs = torch.softmax(logits, dim=1).to(dt).float()
    pvh = pe_v.to(dt).reshape(s, window, heads, dh).float()
    out = torch.einsum("swhp,swhdp->sphd", probs, vch)
    out = out + torch.einsum("swhp,swhd->sphd", probs, pvh)
    return out.to(dt).reshape(s, hw, c)


def _launch(name, q_full, cache_data, scales, extra, pe_v, scale, heads) -> torch.Tensor:
    """Check the arguments the kernel takes, launch it, count the launch."""
    _build.no_grad_through(name, q_full, cache_data, scales, extra, pe_v)
    s, hw, c = q_full.shape
    window = cache_data.shape[2]
    _build.require(q_full, "q_full", torch.bfloat16, 3)
    _build.require(cache_data, "cache_data", torch.int8 if scales is not None else torch.bfloat16, 5)
    if scales is not None:
        _build.require(scales, "scales", torch.float32, 4)
    _build.require(extra, "extra", torch.float32, 4)
    _build.require(pe_v, "pe_v", torch.float32, 3)
    if (
        tuple(cache_data.shape) != (s, 2, window, c, hw)
        or (scales is not None and tuple(scales.shape) != (s, 2, window, c))
        or tuple(extra.shape) != (s, window, heads, hw)
        or tuple(pe_v.shape) != (s, window, c)
        or window != WINDOW
        or c % heads
    ):
        raise ValueError(
            f"{name}: unsupported shapes q {tuple(q_full.shape)}, "
            f"cache {tuple(cache_data.shape)}, "
            f"scales {None if scales is None else tuple(scales.shape)}, "
            f"extra {tuple(extra.shape)}, pe_v {tuple(pe_v.shape)}, heads {heads}"
        )
    staging, cluster = plan(s, hw, c, heads, cache_data.element_size(),
                            _sm_count(q_full.device.index or 0),
                            aligned=cache_data.data_ptr() % 16 == 0)
    out = torch.empty_like(q_full)
    fn = getattr(_build.load("stream_attention"), name)
    ptrs = [q_full.data_ptr(), cache_data.data_ptr()]
    if scales is not None:
        ptrs.append(scales.data_ptr())
    ptrs += [extra.data_ptr(), pe_v.data_ptr(), out.data_ptr()]
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(*ptrs, s, window, c, hw, heads, float(scale), cluster, int(staging == "tma"),
            _build.stream_handle(q_full))
    _build.check(rc, name)
    _build.launch_counts[name] += 1
    route_counts[staging] += 1
    route_counts["cluster"] += cluster > 1
    return out


def tensor_map_encode_stats():
    """(host ns spent encoding TMA tensor maps, launches that encoded them)
    summed over both entries of ``csrc/stream_attention.cu`` since it was
    loaded: each launch on the ``tma`` route encodes one map on the host."""
    fn = _build.load("stream_attention").stream_attention_encode_stats
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_longlong
    calls = ctypes.c_longlong(0)
    ns = fn(ctypes.byref(calls))
    return ns, calls.value


def stream_window_attention_int8(
    q_full: torch.Tensor,  # [s, HW, C] bf16
    cache_data: torch.Tensor,  # [s, 2, 16, C, HW] int8
    scales: torch.Tensor,  # [s, 2, 16, C] f32
    extra: torch.Tensor,  # [s, 16, heads, HW] f32
    pe_v: torch.Tensor,  # [s, 16, C] f32
    scale: float,
    heads: int,
) -> torch.Tensor:
    """Launch the int8-cache kernel on CUDA tensors; a CPU tensor runs the
    plain version. Returns [s, HW, C] in q's dtype."""
    if not q_full.is_cuda:
        return stream_window_attention_plain(
            q_full, cache_data, scales, extra, pe_v, scale, heads
        )
    return _launch(NAME_INT8, q_full, cache_data, scales, extra, pe_v, scale, heads)


def stream_window_attention_bf16(
    q_full: torch.Tensor,  # [s, HW, C] bf16
    cache_data: torch.Tensor,  # [s, 2, 16, C, HW] bf16
    extra: torch.Tensor,  # [s, 16, heads, HW] f32
    pe_v: torch.Tensor,  # [s, 16, C] f32
    scale: float,
    heads: int,
) -> torch.Tensor:
    """Launch the bf16-cache kernel on CUDA tensors; a CPU tensor runs the
    plain version. Returns [s, HW, C] in q's dtype."""
    if not q_full.is_cuda:
        return stream_window_attention_plain(
            q_full, cache_data, None, extra, pe_v, scale, heads
        )
    return _launch(NAME_BF16, q_full, cache_data, None, extra, pe_v, scale, heads)
