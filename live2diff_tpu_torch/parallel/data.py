"""Video-clip data for motion-module training, on the host.

Port of ``live2diff_tpu/parallel/data.py``: fixed-length clip windows from
videos and frame folders, preprocessed on the host (resize, centre crop,
[-1, 1]) into ``[B, F, H, W, 3]`` float32 batches. Plain numpy over the
port's own ``utils/io.py`` and ``utils/image.py``; the shuffle draws from
``np.random.RandomState(seed)`` as the JAX loader does, so one seed gives
the same batches in both.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.image import preprocess_image
from ..utils.io import read_video_frames


def list_videos(root: str, exts: Sequence[str] = (".mp4", ".gif", ".webm")) -> List[str]:
    """Video files and frame-folder directories under ``root``, sorted."""
    out = []
    for name in sorted(os.listdir(root)):
        p = os.path.join(root, name)
        if os.path.isdir(p) or os.path.splitext(name)[1].lower() in exts:
            out.append(p)
    return out


def clip_windows(n_frames: int, clip_len: int, stride: int) -> List[Tuple[int, int]]:
    """(start, end) windows of ``clip_len`` frames every ``stride``."""
    if n_frames < clip_len:
        return []
    return [(s, s + clip_len) for s in range(0, n_frames - clip_len + 1, stride)]


class ClipDataset:
    """All (video, window) pairs across a video root; each video decoded
    once, at first use."""

    def __init__(self, root: str, clip_len: int = 8, stride: int = 8,
                 height: int = 256, width: int = 256,
                 max_frames_per_video: Optional[int] = None):
        self.paths = list_videos(root)
        if not self.paths:
            raise FileNotFoundError(f"no videos/frame folders under {root}")
        self.clip_len, self.stride = clip_len, stride
        self.height, self.width = height, width
        self._frames_cache: dict = {}
        self.index: List[Tuple[int, int]] = []  # (video_idx, start)
        for vi in range(len(self.paths)):
            frames = self._frames(vi, max_frames_per_video)
            for s, _ in clip_windows(len(frames), clip_len, stride):
                self.index.append((vi, s))
        if not self.index:
            raise ValueError(f"no clips of length {clip_len} found (videos too short?)")

    def _frames(self, video_idx: int, max_frames: Optional[int] = None):
        if video_idx not in self._frames_cache:
            self._frames_cache[video_idx] = read_video_frames(self.paths[video_idx], max_frames)
        return self._frames_cache[video_idx]

    def __len__(self) -> int:
        return len(self.index)

    def clip(self, i: int) -> np.ndarray:
        """[F, H, W, 3] float32 in [-1, 1]."""
        vi, s = self.index[i]
        frames = self._frames(vi)[s:s + self.clip_len]
        return np.stack([preprocess_image(f, self.height, self.width) for f in frames])

    def batches(self, batch_size: int, seed: int = 0,
                drop_remainder: bool = True) -> Iterator[np.ndarray]:
        """Shuffled epochs of ``[B, F, H, W, 3]`` batches, forever."""
        rng = np.random.RandomState(seed)
        while True:
            order = rng.permutation(len(self.index))
            for i in range(0, len(order) - (batch_size - 1 if drop_remainder else 0),
                           batch_size):
                idx = order[i:i + batch_size]
                if drop_remainder and len(idx) < batch_size:
                    break
                yield np.stack([self.clip(j) for j in idx])
