"""elementwise_ms: device ms a call in the "elementwise and copies" bucket
of ``tracemath.bucket`` (elementwise kernels, copies, fills, cats and index
kernels of the libraries), the median over the profiled calls."""

import statistics


def read(ctx):
    ms = [sum(d for n, _, d, _ in call if ctx.trace.bucket(n) == ctx.trace.ELEMENTWISE) / 1e3
          for call in ctx.calls]
    if not ms or max(ms) == 0:
        return None
    return statistics.median(ms)
