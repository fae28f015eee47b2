"""stream_attn_roofline_pct: the least time of a call's temporal KV-cache
attentions (``work.stream_attention_calls``: each call's larger of FLOPs
over the bf16 peak and bytes over the HBM bandwidth, each input read once
and the output written once at the cell's cache dtype) over the device time
of the kernels that serve them (the program's stream-attention kernels, #1
for an int8 cache and #2 for a bf16 one), the median call's."""

import statistics

KERNELS = ("#1 stream_attention_int8", "#2 stream_attention_bf16")


def read(ctx):
    if ctx.peaks is None:
        return None
    us = [sum(d for n, _, d, _ in call if ctx.trace.bucket(n) in KERNELS) for call in ctx.calls]
    if not us or statistics.median(us) <= 0:
        return None
    least = ctx.work.least_seconds(ctx.work.stream_attention_calls(ctx.cfg, ctx.traffic),
                                   ctx.peaks["bf16_flops"], ctx.peaks["hbm_bytes"])
    return 100.0 * least / (statistics.median(us) / 1e6)
