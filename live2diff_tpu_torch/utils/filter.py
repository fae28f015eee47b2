"""Similar-image filter: probabilistically skip near-duplicate frames.

Port of ``live2diff_tpu/utils/filter.py`` (host-side numpy, decision for
decision the same; the original Live2Diff's ``SimilarImageFilter``): cosine
similarity between consecutive frames maps to a skip probability
``max(0, 1 - (1 - sim) / (1 - threshold))``; a skipped frame does NOT
update the reference frame. Two reference quirks are preserved because
they are observable behavior: the skip budget resets only when the
``max_skip_frame`` cap forces a frame through (a natural pass leaves the
counter untouched), and the cap itself admits ``max_skip_frame + 1``
consecutive skips. Host-side numpy: this runs before the frame reaches the
device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class SimilarImageFilter:
    def __init__(self, threshold: float = 0.98, max_skip_frame: int = 10):
        self.threshold = threshold
        self.max_skip_frame = max_skip_frame
        self.prev_frame: Optional[np.ndarray] = None
        self.skip_count = 0
        self._rng = np.random.RandomState(0)

    def set_threshold(self, threshold: float) -> None:
        self.threshold = threshold

    def set_max_skip_frame(self, max_skip_frame: int) -> None:
        self.max_skip_frame = max_skip_frame

    def __call__(self, frame: np.ndarray) -> Optional[np.ndarray]:
        """Returns the frame to process, or None to skip (replay previous output)."""
        x = np.asarray(frame, dtype=np.float32).ravel()
        if self.prev_frame is None:
            self.prev_frame = x
            return frame
        # torch CosineSimilarity(eps=1e-6) clamps each norm, so an all-zero
        # frame yields sim ~0 (guaranteed pass), never a divide-by-zero
        denom = max(float(np.linalg.norm(x)), 1e-6) * max(
            float(np.linalg.norm(self.prev_frame)), 1e-6)
        sim = float(x @ self.prev_frame / denom)
        sample = float(self._rng.uniform())
        if self.threshold >= 1:
            skip_prob = 0.0
        else:
            skip_prob = max(0.0, 1.0 - (1.0 - sim) / (1.0 - self.threshold))
        if skip_prob < sample:  # pass: new reference frame, budget untouched
            self.prev_frame = x
            return frame
        if self.skip_count > self.max_skip_frame:  # cap: force through, reset budget
            self.skip_count = 0
            self.prev_frame = x
            return frame
        self.skip_count += 1
        return None
