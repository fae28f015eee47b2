"""PSNR between two videos or frame folders: the port's counterpart of
``tools/psnr.py``.

    python -m live2diff_tpu_torch.tools.psnr ours reference [--max-frames N]

Prints one JSON line: the mean PSNR over the frames both hold, the lowest
frame's and the count. Frames are read by ``utils/io.py``: frame folders
and GIFs through Pillow, video files through imageio where it is installed.
Runs on the host.
"""

from __future__ import annotations

import argparse
import json
from typing import Sequence

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """PSNR in dB of ``a`` against ``b``; inf where they are equal."""
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak**2 / mse))


def score(ours: Sequence[np.ndarray], reference: Sequence[np.ndarray]) -> dict:
    """Mean and lowest per-frame PSNR over the frames both sequences hold."""
    n = min(len(ours), len(reference))
    if n == 0:
        raise ValueError("no overlapping frames to score")
    scores = [psnr(np.asarray(ours[i]), np.asarray(reference[i])) for i in range(n)]
    return {"value": round(float(np.mean(scores)), 2),
            "per_frame_min": round(float(np.min(scores)), 2), "frames": n}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="psnr", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("ours")
    p.add_argument("reference")
    p.add_argument("--max-frames", type=int, default=None)
    args = p.parse_args(argv)

    from ..utils.io import read_video_frames

    result = score(read_video_frames(args.ours, args.max_frames),
                   read_video_frames(args.reference, args.max_frames))
    print(json.dumps({"metric": "psnr_vs_reference", "unit": "dB", **result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
