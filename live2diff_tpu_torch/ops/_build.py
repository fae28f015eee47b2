"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use with ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, and loaded with
``ctypes``: no PyTorch headers, so a build takes seconds. Libraries go to
``build/kernels/`` at the repository root, named by a hash of their source
and of the shared headers (``csrc/*.cuh``), so an edited source or header is
rebuilt and an unchanged one is reused.

``register`` loads a library built elsewhere in place of a build: the warm
start from a primed engine directory (``aot.py``).

Nothing here runs at import time: the CPU tests import every module of the
port on a machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

import torch

from ..utils.timing import RECORDER

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

# source name -> ctypes handle of its built library
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

# launches of each kernel, counted by its wrapper where it launches and
# nowhere else; chip_smoke.py zeroes them around the main path
launch_counts: Dict[str, int] = {
    "stream_attention_int8": 0,
    "stream_attention_bf16": 0,
    "flash_attention": 0,
    "conv3x3": 0,
    "conv3x3_s2": 0,
    "layer_norm": 0,
    "flash_attention_smajor": 0,
    "flash_attention_int8": 0,
    "group_norm": 0,
    "flash_train_fwd": 0,
    "flash_train_bwd": 0,
}

# every source under csrc/, by the name load() and build() take
SOURCES = ("stream_attention", "flash_attention", "flash_attention_int8", "conv3x3",
           "layer_norm", "group_norm", "flash_train")


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and every shared header it may include
    for path in [os.path.join(CSRC_DIR, name + ".cu"),
                 *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every listed source that is not built yet, one ``nvcc`` each,
    all started together. Returns {name: library path}; raises on a failed
    build with the compiler's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for name, path in paths.items():
        if os.path.isfile(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp)
    errors = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, paths[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first use;
    each build and load counted as ``kernel_loads`` in the recorder)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            t0 = time.perf_counter()
            lib = ctypes.CDLL(build([name])[name])
            _LIBS[name] = lib
            RECORDER.count("kernel_loads", seconds=time.perf_counter() - t0)
        return lib


def loaded() -> Dict[str, str]:
    """{source name: path} of every library loaded in this process."""
    with _LOCK:
        return {name: lib._name for name, lib in _LIBS.items()}


def register(name: str, path: str) -> ctypes.CDLL:
    """Load the already built library at ``path`` as ``csrc/<name>.cu``'s:
    ``load(name)`` then returns it, and neither builds nor looks in
    ``BUILD_DIR``. Loading a library runs its initialisers: ``path`` must be
    as trusted as this package's own sources (``aot.py``)."""
    lib = ctypes.CDLL(path)
    with _LOCK:
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a ``cudaError_t`` returned by a C launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as an int for ctypes."""
    return torch.cuda.current_stream(t.device).cuda_stream


def needs_grad(*tensors) -> bool:
    """Whether autograd needs a gradient through a call on ``tensors``:
    grad mode is on and one of them (None aside) requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def no_grad_through(what: str, *tensors) -> None:
    """Raise where autograd would need a gradient through a launch
    (``needs_grad``). A ctypes launch returns tensors without a
    ``grad_fn``, so the gradient would be lost without a word. Every kernel
    wrapper calls this before it launches; only
    ``flash_train.FlashAttentionTrain`` has a backward, and it launches its
    kernels with grad mode off."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward, and a gradient is needed through it; "
            "run it under torch.no_grad(), or train in fp32 (the attention's training kernels)")


def require(t: torch.Tensor, what: str, dtype: torch.dtype, ndim: int) -> None:
    """Checks a kernel makes of each tensor argument before it launches."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
