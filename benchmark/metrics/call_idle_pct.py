"""call_idle_pct: the share of a call's period in which the captured step
does not run on the device, without the profiler: 100 x (1 - the median
``step_device_ms`` (the step's first stage event to its last, CUDA events
recorded inside the graph) / the median period from one call's root span
start to the next's), over the unprofiled window's calls, as the program's
recorder (``live2diff_tpu_torch/utils/timing.py``) holds them. None where
the program records no stage events (the CPU, a program without them)."""

import statistics


def read(ctx):
    from live2diff_tpu_torch.utils import timing

    rec = getattr(timing, "RECORDER", None)
    if rec is None:
        return None
    t = ctx.traffic
    calls = rec.calls(skip_first=t["setup_calls"], skip_last=t["trace_calls"] + 1)
    device = [c.device_ms for c in calls if c.stages is not None]
    periods = [(b.start_ns - a.start_ns) / 1e6 for a, b in zip(calls, calls[1:])
               if b.call == a.call + 1]
    if not device or not periods:
        return None
    return 100.0 * (1.0 - statistics.median(device) / statistics.median(periods))
