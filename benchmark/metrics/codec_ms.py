"""codec_ms: device ms a call of the captured step's codec stages, its
``device.encode`` (the batched TAESD encode of frames and depth images and
the noise) and ``device.decode`` summed in each call, from the CUDA events
the graph records around them; the median over the unprofiled window's
calls, as the program's recorder (``live2diff_tpu_torch/utils/timing.py``)
holds them. None where the program records no stage events (the CPU, a
program without them)."""

import statistics


def read(ctx):
    from live2diff_tpu_torch.utils import timing

    rec = getattr(timing, "RECORDER", None)
    if rec is None:
        return None
    t = ctx.traffic
    calls = rec.calls(skip_first=t["setup_calls"], skip_last=t["trace_calls"] + 1)
    ms = [c.stages["device.encode"] + c.stages["device.decode"]
          for c in calls if c.stages is not None]
    return statistics.median(ms) if ms else None
