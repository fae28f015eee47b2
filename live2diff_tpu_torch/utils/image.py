"""Host-side image pre- and post-processing.

Port of ``live2diff_tpu/utils/image.py``: resize and centre-crop to the
target, [0, 1] -> [-1, 1], and back with an ``output_type`` (``"pil"``,
``"np"``, ``"pt"``, ``"latent"``). Channels-last throughout.

Arrays at the target size need nothing but numpy. Pillow is imported only
by the branches that need it (a PIL input, a resize, ``"pil"`` output), so
the module imports where Pillow is not installed; those branches raise an
``ImportError`` that says so. ``"pt"`` and ``"latent"`` return torch
tensors where they are (a frame on the card stays there); ``"np"`` and
``"pil"`` bring frames to the host.
"""

from __future__ import annotations

import sys
from typing import List, Sequence, Union

import numpy as np
import torch


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "Pillow (PIL) is needed to read PIL images, to resize frames and to return "
            "output_type='pil'; pass [H, W, 3] arrays at the pipeline's size and "
            "output_type 'np' or 'pt' where it is not installed") from e
    return Image


def _is_pil(image) -> bool:
    module = sys.modules.get("PIL.Image")
    return module is not None and isinstance(image, module.Image)


def _to_numpy(image) -> np.ndarray:
    if isinstance(image, torch.Tensor):
        return image.detach().cpu().numpy()
    return np.asarray(image)


def preprocess_image(image, height: int, width: int) -> np.ndarray:
    """A PIL image or an [H, W, 3] / [3, H, W] array (uint8, or float in
    [0, 1]) -> float32 [height, width, 3] in [-1, 1]. A PIL image is scaled
    to cover the target and centre-cropped; an array of another size is
    resized bilinearly."""
    if _is_pil(image):
        Image = _pil_image()
        img = image.convert("RGB")
        scale = max(width / img.width, height / img.height)
        img = img.resize((round(img.width * scale), round(img.height * scale)), Image.BILINEAR)
        left = (img.width - width) // 2
        top = (img.height - height) // 2
        img = img.crop((left, top, left + width, top + height))
        arr = np.asarray(img, dtype=np.float32) / 255.0
    else:
        arr = _to_numpy(image).astype(np.float32)
        if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
            arr = np.transpose(arr, (1, 2, 0))  # CHW -> HWC
        if arr.max() > 2.0:
            arr = arr / 255.0
        if arr.shape[:2] != (height, width):
            Image = _pil_image()
            arr = np.asarray(
                Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)).resize(
                    (width, height), Image.BILINEAR),
                dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0


def postprocess_image(image, output_type: str = "pil"
                      ) -> Union[list, np.ndarray, torch.Tensor]:
    """[-1, 1] float or uint8 ([0, 255], from a pipeline with
    ``output_uint8``) frames [B?, H, W, 3] -> the requested type: ``"np"``
    uint8 arrays, ``"pil"`` images, ``"pt"`` float tensors in [0, 1],
    ``"latent"`` the input as a tensor (float32 unless uint8)."""
    if output_type in ("pt", "latent"):
        t = torch.as_tensor(image)
        if output_type == "latent":
            return t if t.dtype == torch.uint8 else t.float()
        if t.dtype == torch.uint8:
            return t.float() / 255.0
        return (torch.clamp(t.float(), -1.0, 1.0) + 1.0) / 2.0
    arr = _to_numpy(image)
    squeeze = arr.ndim == 3
    if squeeze:
        arr = arr[None]
    if arr.dtype == np.uint8:
        uint8 = arr
    else:
        arrf = (np.clip(arr.astype(np.float32), -1.0, 1.0) + 1.0) / 2.0
        uint8 = (arrf * 255).round().astype(np.uint8)
    if output_type == "np":
        return uint8[0] if squeeze else uint8
    if output_type != "pil":
        raise ValueError(f"output_type {output_type!r}: expected pil, np, pt or latent")
    Image = _pil_image()
    pils: List = [Image.fromarray(frame) for frame in uint8]
    return pils[0] if squeeze else pils


def frames_to_uint8(frames: Sequence) -> np.ndarray:
    """[-1, 1] float (or uint8) frames, arrays or tensors -> [N, H, W, 3]
    uint8 on the host."""
    arrs = [_to_numpy(f) for f in frames]
    if all(a.dtype == np.uint8 for a in arrs):
        return np.stack(arrs)
    out = np.stack([a.astype(np.float32) for a in arrs])
    return ((np.clip(out, -1, 1) + 1) * 127.5).round().astype(np.uint8)
