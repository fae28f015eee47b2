"""mfu_pct: model FLOPs a second over the card's bf16 peak. The FLOPs of a
call come from the configuration's shapes (``work.model_flops``: the
stream-batch UNet with its motion modules, the DPT-hybrid, the TAESD encode
and decode); the rate is the frames a second of the run's unprofiled
window, S frames a call."""


def read(ctx):
    if ctx.peaks is None or ctx.fps <= 0:
        return None
    calls_per_s = ctx.fps / ctx.traffic["sessions"]
    return 100.0 * ctx.work.model_flops(ctx.cfg, ctx.traffic) * calls_per_s / ctx.peaks["bf16_flops"]
