"""unet_ms: device ms a call of the captured step's ``device.unet`` stage
(the stream-batch UNet with its motion modules over the step rows, from
the CUDA events the graph records before and after it), the median over
the unprofiled window's calls, as the program's recorder
(``live2diff_tpu_torch/utils/timing.py``) holds them. None where the
program records no stage events (the CPU, a program without them)."""

import statistics


def read(ctx):
    from live2diff_tpu_torch.utils import timing

    rec = getattr(timing, "RECORDER", None)
    if rec is None:
        return None
    t = ctx.traffic
    calls = rec.calls(skip_first=t["setup_calls"], skip_last=t["trace_calls"] + 1)
    ms = [c.stages["device.unet"] for c in calls if c.stages is not None]
    return statistics.median(ms) if ms else None
