"""Fused 3x3 convolutions (stride 1 and 2): kernel wrapper and plain version.

The CUDA kernel (``csrc/conv3x3.cu``, one template for both strides)
replaces the Pallas TPU kernels ``live2diff_tpu/ops/conv.py:conv3x3_fused``
and ``conv3x3_s2_fused``: a padding-1 3x3 conv over NHWC activations with
fp32 accumulation, fused bias, residual skip (added before the ReLU) and
ReLU. It is an implicit GEMM on Hopper's ``wgmma``, its input tiles loaded
by TMA (when Cin % 8 == 0) into a ring of stages; the source's note says
how. ``conv3x3_plain`` is the same function in plain torch.

Weights are in torch's ``[Cout, Cin, 3, 3]`` layout, the layout of the
modules that hold them; activations keep the JAX package's NHWC layout.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

NAMES = {1: "conv3x3", 2: "conv3x3_s2"}


def conv3x3_plain(
    x: torch.Tensor,  # [B, H, W, Cin]
    w: torch.Tensor,  # [Cout, Cin, 3, 3]
    bias: Optional[torch.Tensor] = None,  # [Cout]
    skip: Optional[torch.Tensor] = None,  # [B, Ho, Wo, Cout]
    relu: bool = False,
    stride: int = 1,
) -> torch.Tensor:
    """Plain torch version: the conv of x and w in fp32 (their dtype's
    values, exact in fp32; set ``torch.backends.cudnn.allow_tf32 = False``
    for a full-fp32 reference on the card), + bias + skip, ReLU, cast back
    to x's dtype."""
    out = F.conv2d(x.permute(0, 3, 1, 2).float(), w.float(), None, stride, 1)
    out = out.permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.float()
    if skip is not None:
        out = out + skip.float()
    if relu:
        out = torch.relu(out)
    return out.to(x.dtype).contiguous()


@functools.cache
def _launcher():
    """The C entry, built and loaded at first use, its argument types set once."""
    fn = _build.load("conv3x3").conv3x3
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def conv3x3(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    skip: Optional[torch.Tensor] = None,
    relu: bool = False,
    stride: int = 1,
) -> torch.Tensor:
    """``relu?(conv3x3(x, w, stride, padding 1) + bias + skip)``, NHWC.

    Launches the CUDA kernel on CUDA tensors (bf16, contiguous, Cout = 64,
    Cin <= 64, even H and W at stride 2); a CPU tensor runs the plain
    version."""
    if not x.is_cuda:
        return conv3x3_plain(x, w, bias, skip, relu, stride)
    name = NAMES.get(stride)
    _build.no_grad_through(name or "conv3x3", x, w, bias, skip)
    b, h, wd, cin = x.shape
    cout = w.shape[0]
    _build.require(x, "x", torch.bfloat16, 4)
    _build.require(w, "w", torch.bfloat16, 4)
    ho, wo = (h, wd) if stride == 1 else (h // 2, wd // 2)
    if (
        name is None or tuple(w.shape) != (cout, cin, 3, 3) or cout != 64 or cin > 64
        or (stride == 2 and (h % 2 or wd % 2)) or b > 65535
        or (cin % 8 == 0 and x.data_ptr() % 16)
    ):
        raise ValueError(
            f"conv3x3: unsupported x {tuple(x.shape)}, w {tuple(w.shape)}, stride {stride}"
        )
    if bias is not None:
        _build.require(bias, "bias", torch.bfloat16, 1)
        if bias.shape[0] != cout or bias.data_ptr() % 4:
            raise ValueError(f"conv3x3: bias {tuple(bias.shape)} for {cout} channels")
    if skip is not None:
        _build.require(skip, "skip", torch.bfloat16, 4)
        if tuple(skip.shape) != (b, ho, wo, cout) or skip.data_ptr() % 4:
            raise ValueError(f"conv3x3: skip {tuple(skip.shape)}, out {(b, ho, wo, cout)}")
    out = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    rc = _launcher()(
        x.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if skip is None else skip.data_ptr(),
        out.data_ptr(), b, h, wd, cin, cout, stride, int(relu), _build.stream_handle(x),
    )
    _build.check(rc, name)
    _build.launch_counts[name] += 1
    return out


def tensor_map_encode_stats():
    """(host ns spent encoding TMA tensor maps, launches that encoded them)
    over both strides since ``csrc/conv3x3.cu`` was loaded: each launch with
    Cin % 8 == 0 encodes one map on the host."""
    fn = _build.load("conv3x3").conv3x3_encode_stats
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_longlong
    calls = ctypes.c_longlong(0)
    ns = fn(ctypes.byref(calls))
    return ns, calls.value
