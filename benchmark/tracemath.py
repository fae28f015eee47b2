"""The arithmetic that turns a profiler trace into per-call device numbers.

Copied from the measured program's ``tools/trace_step.py`` so that the
yardstick stays fixed whatever later changes that tool: the buckets of
kernel names (the program's hand-written kernels by name, then cuDNN
convs, cuBLAS GEMMs, elementwise kernels and copies), ``family`` (a kernel
name without its template and argument lists), the union of busy
intervals, and the assignment of each device record to the call whose
runtime launch produced it (the profiler's correlation id).
"""

from __future__ import annotations

import bisect
import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

# (name, start us, duration us, launched by a graph replay) of one device
# record
Event = Tuple[str, float, float, bool]

PORT_KERNELS = {
    "#1 stream_attention_int8": r"stream_attention_kernel<signed char,",
    "#2 stream_attention_bf16": r"stream_attention_kernel<__nv_bfloat16,",
    "#3 flash_attention (d-major)": r"flash_sm90_kernel<\d+, false, false>",
    "#3 flash_train (fp32)": r"flash_train_\w+_kernel<",
    "#4 flash_attention_smajor": r"flash_sm90_kernel<\d+, true, false>",
    "#5 flash_attention_int8": r"flash_sm90_kernel<\d+, true, true>|quantise_kernel\(",
    "#6 conv3x3": r"conv3x3_sm90<1, ",
    "#7 conv3x3_s2": r"conv3x3_sm90<2, ",
    "#8 group_norm": r"group_norm_kernel<",
    "#9 layer_norm": r"layer_norm_kernel<",
}
LIBRARY_BUCKETS = (
    ("cuDNN convs", r"conv|fprop|dgrad|wgrad|cudnn|implicit_convolve"),
    ("cuBLAS GEMMs", r"gemm|nvjet|cutlass|cublas|xmma"),
    ("elementwise and copies", r"elementwise|[Mm]emcpy|[Mm]emset|copy|Copy|fill|cat|index"),
)
ELEMENTWISE = "elementwise and copies"
GEMMS = "cuBLAS GEMMs"

# the CUDA API calls that launch device work
RUNTIME_CALL = re.compile(r"^cu(da)?[A-Z]")


def family(name: str) -> str:
    """``void at::native::f<4, g<h>>(int)`` -> ``at::native::f``."""
    name = name.replace("(anonymous namespace)", "{anonymous}")
    prev = None
    while prev != name:
        prev, name = name, re.sub(r"<[^<>]*>", "", name)
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.removeprefix("void ").strip()


def bucket(name: str) -> str:
    """The program's kernel by wrapper (by the full name), else the library
    bucket of the name's family, else ``other``."""
    for label, pat in PORT_KERNELS.items():
        if re.search(pat, name):
            return label
    fam = family(name)
    for label, pat in LIBRARY_BUCKETS:
        if re.search(pat, fam):
            return label
    return "other"


def union_us(events: Sequence[Event]) -> float:
    """Time covered by at least one of ``events``."""
    busy, end = 0.0, float("-inf")
    for _, start, dur, _ in sorted(events, key=lambda e: e[1]):
        stop = start + dur
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def idle_gaps(events: Sequence[Event], lo: float, hi: float) -> List[Tuple[float, float]]:
    """(start, end) of every stretch of [lo, hi] that no event covers."""
    gaps, cursor = [], lo
    for _, start, dur, _ in sorted(events, key=lambda e: e[1]):
        if start > cursor:
            gaps.append((cursor, min(start, hi)))
        cursor = max(cursor, start + dur)
        if cursor >= hi:
            break
    if cursor < hi:
        gaps.append((cursor, hi))
    return [g for g in gaps if g[1] > g[0]]


def _call_at(windows: Sequence[Tuple[float, float]], t: float) -> Optional[int]:
    i = bisect.bisect_right([lo for lo, _ in windows], t) - 1
    return i if i >= 0 and t < windows[i][1] else None


def assign_by_correlation(device: Sequence[Tuple[int, str, float, float]],
                          runtime: Sequence[Tuple[int, str, float]],
                          windows: Sequence[Tuple[float, float]]
                          ) -> Tuple[List[List[Event]], List[str]]:
    """Each (correlation id, name, start us, duration us) device record in
    the call whose runtime call (correlation id, call name, host start us)
    launched it; ``windows`` are the calls' host ranges. Returns the calls'
    events and the names of the records launched in no call."""
    launched = {}
    for corr, call, start in runtime:
        f = _call_at(windows, start)
        if f is not None:
            launched[corr] = (f, "GraphLaunch" in call)
    calls: List[List[Event]] = [[] for _ in windows]
    unassigned = []
    for corr, name, start, dur in device:
        if corr in launched:
            f, graph = launched[corr]
            calls[f].append((name, start, dur, graph))
        else:
            unassigned.append(name)
    return calls, unassigned


def totals_us(calls: Sequence[Sequence[Event]], key) -> Dict[str, float]:
    """Device us over all the calls by ``key(name)``."""
    total = Counter()
    for group in calls:
        for name, _, dur, _ in group:
            total[key(name)] += dur
    return dict(total)


def label_gaps(gaps: Sequence[Tuple[float, float]],
               host: Sequence[Tuple[str, float, float]], top: int = 10,
               longest: int = 400) -> List[List]:
    """The ``longest`` gaps, each named by the innermost host op (name,
    start us, end us) that spans its middle, summed by name: the ``top``
    names as [name, seconds]."""
    picked = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
    total = Counter()
    for lo, hi in picked:
        mid = (lo + hi) / 2
        inner = None
        for name, start, end in host:
            if start <= mid < end and (inner is None or end - start < inner[1]):
                inner = (name, end - start)
        total[inner[0] if inner else "no host op (Python between calls)"] += (hi - lo) / 1e6
    return [[name, s] for name, s in total.most_common(top)]
