"""Video and frame I/O on the host.

Port of ``live2diff_tpu/utils/io.py``: a folder of numbered images, a GIF
or a video file in; a GIF, a PNG folder or a video file out. Pillow reads
and writes images and GIFs, imageio video files; both are imported only
when a call needs them, and raise an ``ImportError`` that says which
package is missing.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading or writing images and GIFs needs Pillow (PIL)") from e
    return Image


def _imageio():
    try:
        import imageio.v3 as iio
    except ImportError as e:
        raise ImportError("reading or writing video files needs imageio") from e
    return iio


def _numeric_key(name: str):
    nums = re.findall(r"\d+", name)
    return (int(nums[-1]) if nums else 0, name)


def read_video_frames(path: str, max_frames: Optional[int] = None) -> List[np.ndarray]:
    """Frames as uint8 [H, W, 3] arrays from a video file, a GIF, or a
    directory of numbered images (in the order of their last number)."""
    frames: List[np.ndarray] = []
    if os.path.isdir(path):
        Image = _pil_image()
        names = sorted((n for n in os.listdir(path)
                        if n.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".webp"))),
                       key=_numeric_key)
        for n in names:
            with Image.open(os.path.join(path, n)) as img:
                frames.append(np.asarray(img.convert("RGB")))
            if max_frames and len(frames) >= max_frames:
                break
        return frames

    if path.lower().endswith(".gif"):
        Image = _pil_image()
        with Image.open(path) as img:
            try:
                while True:
                    frames.append(np.asarray(img.convert("RGB")))
                    if max_frames and len(frames) >= max_frames:
                        break
                    img.seek(img.tell() + 1)
            except EOFError:
                pass
        return frames

    iio = _imageio()
    try:
        for frame in iio.imiter(path):
            frames.append(np.asarray(frame)[..., :3])
            if max_frames and len(frames) >= max_frames:
                break
    except Exception as e:  # which codecs exist depends on the host
        raise RuntimeError(f"cannot decode video {path}: {e}") from e
    return frames


def _write_png_folder(folder: str, frames: np.ndarray) -> None:
    Image = _pil_image()
    os.makedirs(folder, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(folder, f"{i:06d}.png"))


def write_video(path: str, frames: np.ndarray, fps: int = 16) -> None:
    """Write [N, H, W, 3] uint8 frames: a ``.gif``, a PNG folder (a path
    with no extension), or a video file through imageio (a PNG folder
    beside it, ``<name>_frames``, where no codec takes it)."""
    frames = np.asarray(frames)
    if path.lower().endswith(".gif"):
        Image = _pil_image()
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=max(1, int(1000 / fps)), loop=0)
        return
    if os.path.splitext(path)[1] == "" or path.endswith(os.sep):
        _write_png_folder(path, frames)
        return
    iio = _imageio()
    try:
        iio.imwrite(path, frames, fps=fps)
    except Exception:  # no codec for this container here
        _write_png_folder(os.path.splitext(path)[0] + "_frames", frames)


def save_videos_grid(frames_list: List[np.ndarray], path: str, fps: int = 16) -> None:
    """Clips of [N, H, W, 3] frames side by side, cut to the shortest."""
    n = min(len(f) for f in frames_list)
    grid = np.concatenate([np.asarray(f[:n]) for f in frames_list], axis=2)
    write_video(path, grid, fps=fps)
