"""Timing and profiling instrumentation.

Port of ``live2diff_tpu/utils/timing.py``: ``EmaTimer``, per-stage host
wall-clock timers (the caller synchronises the device inside ``track``),
and ``profile_trace``, a ``torch.profiler`` capture written as a Chrome
trace (open it in Perfetto or ``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional


class EmaTimer:
    """Per-stage EMA and full history; the summary's mean and std leave the
    first sample out (it pays the builds and loads), as the JAX timer's do."""

    def __init__(self, decay: float = 0.9):
        self.decay = decay
        self.ema: Dict[str, float] = {}
        self.history: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def track(self, stage: str):
        t0 = time.perf_counter()
        yield
        self.add(stage, time.perf_counter() - t0)

    def add(self, stage: str, dt: float) -> None:
        if stage in self.ema:
            self.ema[stage] = self.decay * self.ema[stage] + (1 - self.decay) * dt
        else:
            self.ema[stage] = dt
        self.history.setdefault(stage, []).append(dt)

    def summary(self) -> Dict[str, Dict[str, float]]:
        import numpy as np

        out = {}
        for stage, times in self.history.items():
            arr = np.asarray(times[1:] or times)
            out[stage] = {
                "ema_s": self.ema[stage],
                "mean_s": float(arr.mean()),
                "std_s": float(arr.std()),
                "count": len(times),
            }
        return out


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block, CPU and (where there is a card)
    CUDA activity, its Chrome trace written into ``log_dir`` as
    ``trace-<pid>-<ns>.json``. Yields the profiler, or None and records
    nothing for a falsy ``log_dir``."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
