"""device_idle_pct: the share of the profiled calls' wall time, first
call's start to last call's end, in which no device record (kernel, copy or
set) ran: the union of their intervals, as ``tools/trace_step.py`` takes
busy time."""


def read(ctx):
    if ctx.window_us <= 0 or ctx.busy_us <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_us / ctx.window_us)
