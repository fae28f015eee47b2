"""flash_attn_roofline_pct: the least time of a call's softmax attentions
over whole sequences (``work.flash_attention_calls``: the UNet's spatial
self- and cross-attentions and the DPT ViT's self-attentions, counted from
the configuration's shapes, not from the program's routing) over the
device time of the program's flash kernels (#3, #4, #5), the median call's.
A call's least time is the larger of its FLOPs over the bf16 peak and its
bytes (q, k, v and the output in bf16) over the HBM bandwidth."""

import statistics

KERNELS = ("#3 flash_attention (d-major)", "#4 flash_attention_smajor",
           "#5 flash_attention_int8")


def read(ctx):
    if ctx.peaks is None:
        return None
    us = [sum(d for n, _, d, _ in call if ctx.trace.bucket(n) in KERNELS) for call in ctx.calls]
    if not us or statistics.median(us) <= 0:
        return None
    least = ctx.work.least_seconds(ctx.work.flash_attention_calls(ctx.cfg, ctx.traffic),
                                   ctx.peaks["bf16_flops"], ctx.peaks["hbm_bytes"])
    return 100.0 * least / (statistics.median(us) / 1e6)
