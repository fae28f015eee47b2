"""kernels_per_frame: device kernels a call of the entry (a frame for one
stream, a round of S frames for a MultiStream), the median over the
profiled calls: copies and sets are not counted, and the median keeps the
few records the profiler drops out of the number."""

import statistics


def read(ctx):
    counts = [sum(not n.startswith(("Memcpy", "Memset")) for n, _, _, _ in call)
              for call in ctx.calls]
    if not counts or max(counts) == 0:
        return None
    return float(statistics.median(counts))
