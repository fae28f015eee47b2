"""gemm_ms: device ms a call in the "cuBLAS GEMMs" bucket of
``tracemath.bucket``, the median over the profiled calls."""

import statistics


def read(ctx):
    ms = [sum(d for n, _, d, _ in call if ctx.trace.bucket(n) == ctx.trace.GEMMS) / 1e3
          for call in ctx.calls]
    if not ms or max(ms) == 0:
        return None
    return statistics.median(ms)
