"""codec_attn_ms: device ms a call of the KL codec's attentions (the mid
block's one-head self-attention of the encode and of the decode, each with
its GroupNorm, projections and residual), summed in each call from the CUDA
events the captured graph records before and after each (the recorder's
``device.codec_attn`` stage), the median over the unprofiled window's
calls, as the program's recorder (``live2diff_tpu_torch/utils/timing.py``)
holds them. None where the program records no such stage (TAESD, the CPU,
a program without these events)."""

import statistics

STAGE = "device.codec_attn"


def read(ctx):
    from live2diff_tpu_torch.utils import timing

    rec = getattr(timing, "RECORDER", None)
    if rec is None:
        return None
    t = ctx.traffic
    calls = rec.calls(skip_first=t["setup_calls"], skip_last=t["trace_calls"] + 1)
    ms = [c.stages[STAGE] for c in calls if c.stages is not None and STAGE in c.stages]
    return statistics.median(ms) if ms else None
