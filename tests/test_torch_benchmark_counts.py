"""The benchmark's work counts and trace arithmetic (``benchmark/work.py``,
``benchmark/tracemath.py``) against hand counts, in the repo's own test run.

The tests live beside the benchmark, in
``benchmark/tests/test_benchmark_counts.py``; this file collects them
unchanged, so that the arithmetic every traced cell reads (kernel buckets
and families, the union of device intervals and the gaps between them,
each kernel in the call that launched it by correlation id) and the frozen
work counts of each cell are held by the same run as the port.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmark" / "tests"))

from test_benchmark_counts import *  # noqa: E402,F401,F403
