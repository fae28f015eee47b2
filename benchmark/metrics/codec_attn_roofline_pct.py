"""codec_attn_roofline_pct: the least time of a call's KL-codec attentions
(``codec_attention_calls`` of the configuration's reference module, through
``work.own_calls``: each call's larger of FLOPs over the bf16 peak and
bytes over the HBM bandwidth, the projections included) over the device
time the captured step's events give them (the recorder's
``device.codec_attn`` stage, as ``codec_attn_ms`` reads it), the median
call's. None without the card's peaks, without such calls in the
configuration, or where the program records no such stage."""

import statistics

STAGE = "device.codec_attn"


def read(ctx):
    if ctx.peaks is None:
        return None
    calls_work = ctx.work.own_calls(ctx.cfg, ctx.traffic, "codec_attention_calls")
    if not calls_work:
        return None
    from live2diff_tpu_torch.utils import timing

    rec = getattr(timing, "RECORDER", None)
    if rec is None:
        return None
    t = ctx.traffic
    calls = rec.calls(skip_first=t["setup_calls"], skip_last=t["trace_calls"] + 1)
    ms = [c.stages[STAGE] for c in calls if c.stages is not None and STAGE in c.stages]
    if not ms or statistics.median(ms) <= 0:
        return None
    least = ctx.work.least_seconds(calls_work, ctx.peaks["bf16_flops"], ctx.peaks["hbm_bytes"])
    return 100.0 * least / (statistics.median(ms) / 1e3)
