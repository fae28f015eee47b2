"""Checkpoint files -> CPU state dicts of torch tensors.

Port of ``live2diff_tpu/convert/torch_to_flax.py:load_state_dict_file``.

* ``.safetensors`` is read by ``read_safetensors``, a reader of the format
  itself (an 8-byte little-endian header length, a JSON header naming each
  tensor's dtype, shape and byte range, an optional ``__metadata__`` entry,
  then the raw little-endian bytes), so no ``safetensors`` package is
  needed. The file is read once into one buffer; every tensor is a view of
  it (``torch.frombuffer``).
* ``.ckpt``, ``.pt``, ``.pth`` and ``.bin`` (torch pickles, zip or legacy)
  go through ``torch.load(map_location="cpu", weights_only=True)``, which
  builds tensors and plain containers only and runs no other code. A
  top-level ``state_dict`` entry is unwrapped, and entries that are not
  tensors are dropped, as in the JAX package.
"""

from __future__ import annotations

import json
import os
import struct
import sys
from typing import Dict, Tuple

import torch

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """A ``.safetensors`` file -> (CPU tensors by name, its ``__metadata__``)."""
    if sys.byteorder != "little":
        raise RuntimeError("read_safetensors reads the little-endian bytes in place")
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes in a file of {size}")
        header = json.loads(f.read(n))
        buf = bytearray(size - 8 - n)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: truncated")
    metadata = header.pop("__metadata__", None) or {}
    out = {}
    for name, info in header.items():
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                             f"expected one of {sorted(_SAFETENSORS_DTYPES)}")
        shape = tuple(info["shape"])
        start, end = info["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = (end - start) // itemsize
        expected = 1
        for d in shape:
            expected *= d
        if count != expected or end > len(buf):
            raise ValueError(f"{path}: tensor {name!r} spans bytes [{start}, {end}), "
                             f"which does not hold shape {shape} of {info['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                         offset=start).reshape(shape)
    return out, metadata


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` / ``.ckpt`` / ``.pt`` / ``.pth`` / ``.bin`` file ->
    {name: CPU tensor}, in the file's dtypes."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)[0]
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: expected a state dict, got {type(sd).__name__}")
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
