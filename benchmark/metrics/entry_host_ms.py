"""entry_host_ms: the program's host time a call during which it does not
wait for the device: the entry's root span (``wrapper.img2img``, or
``multi.round`` for a MultiStream) less its ``wrapper.sync`` child, the
median over the unprofiled window's calls, as the program's recorder
(``live2diff_tpu_torch/utils/timing.py``) holds them. None where the
program records no spans."""

import statistics


def read(ctx):
    from live2diff_tpu_torch.utils import timing

    rec = getattr(timing, "RECORDER", None)
    if rec is None:
        return None
    t = ctx.traffic
    calls = rec.calls(skip_first=t["setup_calls"], skip_last=t["trace_calls"] + 1)
    ms = [c.ms - c.spans.get("wrapper.sync", 0) / 1e6 for c in calls]
    return statistics.median(ms) if ms else None
