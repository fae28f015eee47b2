"""A kernel-level profile of the streamed step: the port's counterpart of
``tools/trace_step.py``.

    python -m live2diff_tpu_torch.tools.trace_step [--frames 8] [--height 512]
        [--width 512] [--kv-cache int8|bf16] [--spatial-qk bf16|int8]
        [--sessions S] [--top 40] [--out DIR] [--tiny] [--device cuda|cpu]

Builds bench.py's pipeline (512x512, TAESD, DPT-hybrid, uint8 frames,
random weights; the int8 KV cache by default, the port's main path),
prepares it and streams: one replay of the captured step a frame, each
frame ended by a synchronize, as a caller's frame is. ``--sessions S``
traces ``MultiStream``'s batched round of S sessions instead. After 3 warm
frames, ``--frames`` frames are timed on the host clock, then the same
number run under ``torch.profiler`` (CPU and CUDA activity; ``--out`` also
gets the Chrome trace). Printed per frame:

* the top kernels by device ms, with their launches;
* families: kernel names with their template and argument lists stripped,
  summed over shapes;
* coarse buckets: the port's nine kernels by wrapper (``#n`` is the row of
  PERF.md's table of TPU kernels), cuBLAS GEMMs, cuDNN convs, elementwise
  kernels and copies, and the rest;
* the gaps: the frame's wall time (host clock, to a synchronize) split,
  without the profiler, into the host time before the graph's replay
  (Python, finding the graph, the frame copy's launch), the replay's own
  host time (``cudaGraphLaunch``), and the device span: CUDA events
  recorded just before and just after the replay. The span is busy time
  (the profiled kernels the graph launched) and idle time inside it: the
  device waiting for the launch to submit the graph's first kernel (at
  most the replay's host time) and the gaps between its kernels. The rest
  of the wall time (``host``) is outside the span. The profiler slows the
  replay's kernels down, so the profiled span is printed apart.

Each kernel or copy belongs to the frame whose runtime call launched it,
matched by the profiler's correlation id (the runtime call lies on the
host's clock inside the frame's ``record_function`` range), not by its
device timestamp; a record with no launch in any frame is counted as
``unassigned``. The profiler runs one warm-up frame before the traced
ones (a trace's first frame loses records otherwise). Every frame
replays the same graph, so a frame short of some kernel's records
against the others lost them in the trace: ``dropped_by_frame`` names
them, and ``kernels_full`` counts each kernel name as often as the
fullest frame holds it.

No FLOP count is printed: the JAX tool reads XLA's cost analysis, and a
counter over eager torch ops would not see the hand-written kernels, so it
would give a partial number under a whole number's name.

With ``--device cpu`` (and ``--tiny``) the step runs eagerly and the
profile holds CPU ops (the top-level ones, which do not overlap): host
timings, not a device measurement.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import re
import statistics
import time
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

# (name, start us, duration us, launched by a graph replay) of one kernel,
# copy or CPU op
Event = Tuple[str, float, float, bool]

# the port's kernels by wrapper, by the profiler's kernel names
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
# the rest, in this order (cuDNN's implicit-GEMM convs before the GEMMs)
LIBRARY_BUCKETS = (
    ("cuDNN convs", r"conv|fprop|dgrad|wgrad|cudnn|implicit_convolve"),
    ("cuBLAS GEMMs", r"gemm|nvjet|cutlass|cublas|xmma"),
    ("elementwise and copies", r"elementwise|[Mm]emcpy|[Mm]emset|copy|Copy|fill|cat|index"),
)


def family(name: str) -> str:
    """A kernel's name without its template arguments, argument list and
    return type: ``void at::native::f<4, g<h>>(int)`` -> ``at::native::f``."""
    name = name.replace("(anonymous namespace)", "{anonymous}")
    prev = None
    while prev != name:
        prev, name = name, re.sub(r"<[^<>]*>", "", name)
    name = name.strip()
    if name.endswith(")"):  # the argument list: cut at its matching "("
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.removeprefix("void ").strip()


def bucket(name: str) -> str:
    """The port's kernel by wrapper (by the full name), else the library
    bucket of the name's family, else ``other``."""
    for label, pat in PORT_KERNELS.items():
        if re.search(pat, name):
            return label
    fam = family(name)
    for label, pat in LIBRARY_BUCKETS:
        if re.search(pat, fam):
            return label
    return "other"


def _union_us(events: Sequence[Event]) -> float:
    """Time covered by at least one of ``events`` (sorted by start)."""
    busy, end = 0.0, float("-inf")
    for _, start, dur, _ in events:
        stop = start + dur
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


# bins (us) of the gaps between one event's end and the next one's start
GAP_BINS = (1.0, 2.0, 5.0, 20.0, 100.0)
GAP_LABELS = tuple(f"<{b:g}us" for b in GAP_BINS) + (f">={GAP_BINS[-1]:g}us",)


def _gaps_us(group: Sequence[Event]) -> List[Tuple[float, str, str]]:
    """(gap us, name before, name after) between consecutive events of one
    frame (sorted by start), overlaps counting as no gap."""
    out, end, before = [], None, None
    for name, start, dur, _ in group:
        if end is not None:
            out.append((max(start - end, 0.0), before, name))
        if end is None or start + dur >= end:
            end, before = start + dur, name
    return out


def aggregate(frames: Sequence[Sequence[Event]], wall_ms: Sequence[float], top: int = 40,
              replays: Optional[Sequence[Tuple[float, float, float]]] = None,
              unassigned: int = 0) -> dict:
    """Per-frame sums of a profile, ``frames`` holding each frame's events:
    ``device_ms`` and ``kernels`` (every event's duration and count a
    frame), ``kernels_by_frame``, ``unassigned`` (records no frame
    launched), ``kernels_full`` (each name counted as often as the frame
    that holds most of it does) and ``dropped_by_frame`` ({frame: {name:
    records fewer than that}}), the ``top`` kernels, ``families`` and ``buckets`` (each
    {name: [ms, launches]} a frame, by ms), and ``gaps``, p50s over
    frames: ``busy`` (time covered by the events a graph replay launched,
    or by all where none did), ``span`` (the third of each of
    ``replays``, (host ms before the replay call, host ms inside it,
    device ms between CUDA events just before and just after it) of
    frames run without the profiler; else the profiled span, first
    event's start to last event's end), ``idle_in_span`` (span less
    busy), ``before_replay`` and ``launch`` (the first two of
    ``replays``), and ``host`` (``wall_ms``, frames timed to a
    synchronize without the profiler, less the span). The profiler slows
    a replay's kernels down, so its own span (``profiled_span_ms_p50``) is
    longer than an unprofiled frame's. Where the profiled idle time lies:
    ``between_events``, {bin: [gaps, ms]} a frame of the gaps between
    consecutive events by width (``GAP_BINS``, us; the bin is the upper
    edge), and ``widest``, the 5 widest gaps of all frames with the events
    before and after them."""
    n = len(frames)
    events = [e for group in frames for e in group]

    def per_frame(key) -> Dict[str, List[float]]:
        ms, count = Counter(), Counter()
        for name, _, dur, _ in events:
            ms[key(name)] += dur / 1e3 / n
            count[key(name)] += 1 / n
        return {k: [v, count[k]] for k, v in ms.most_common()}

    counts = [Counter(e[0] for e in group) for group in frames]
    full = Counter()
    for c in counts:
        full |= c
    dropped = {f: dict(full - c) for f, c in enumerate(counts) if full - c}
    graphs = any(e[3] for e in events)
    profiled_spans, busy, between = [], [], []
    for group in frames:
        group = sorted(group, key=lambda e: e[1])
        profiled_spans.append(
            (max(e[1] + e[2] for e in group) - group[0][1]) / 1e3 if group else 0.0)
        busy.append(_union_us([e for e in group if e[3] or not graphs]) / 1e3)
        between += _gaps_us(group)
    bins = Counter(), Counter()
    for gap, _, _ in between:
        label = next((lb for b, lb in zip(GAP_BINS, GAP_LABELS) if gap < b), GAP_LABELS[-1])
        bins[0][label] += 1 / n
        bins[1][label] += gap / 1e3 / n
    spans = [r[2] for r in replays] if replays else profiled_spans
    span_p50, busy_p50 = statistics.median(spans), statistics.median(busy)
    wall_p50 = statistics.median(wall_ms)

    def p50_of(i):
        return statistics.median(r[i] for r in replays) if replays else None

    return dict(
        frames=n,
        device_ms=sum(e[2] for e in events) / 1e3 / n,
        kernels=len(events) / n,
        kernels_by_frame=[len(group) for group in frames], unassigned=unassigned,
        kernels_full=sum(full.values()), dropped_by_frame=dropped,
        top=dict(list(per_frame(lambda name: name).items())[:top]),
        families=dict(list(per_frame(family).items())[:top]),
        buckets=per_frame(bucket),
        gaps=dict(wall_ms_p50=wall_p50, span_ms_p50=span_p50, busy_ms_p50=busy_p50,
                  idle_in_span_ms_p50=span_p50 - busy_p50, host_ms=wall_p50 - span_p50,
                  before_replay_ms_p50=p50_of(0), launch_ms_p50=p50_of(1),
                  profiled_span_ms_p50=statistics.median(profiled_spans), span_ms=spans,
                  busy_ms=busy, wall_ms=list(wall_ms),
                  between_events={k: [bins[0][k], bins[1][k]] for k in GAP_LABELS if k in bins[0]},
                  widest=[list(g) for g in sorted(between, reverse=True)[:5]]),
    )


FRAME_LABEL = "trace_step.frame"


# the CUDA API calls that launch device work (cudaGraphLaunch,
# cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel, ...)
RUNTIME_CALL = re.compile(r"^cu(da)?[A-Z]")


def _frame_at(windows: Sequence[Tuple[float, float]], t: float) -> Optional[int]:
    """The index of the (start, end) window, sorted, that holds ``t``."""
    i = bisect.bisect_right([lo for lo, _ in windows], t) - 1
    return i if i >= 0 and t < windows[i][1] else None


def assign_by_correlation(device: Sequence[Tuple[int, str, float, float]],
                          runtime: Sequence[Tuple[int, str, float]],
                          windows: Sequence[Tuple[float, float]]
                          ) -> Tuple[List[List[Event]], List[str]]:
    """Each of ``device``'s (correlation id, name, start us, duration us)
    records in the frame of the runtime call that launched it: ``runtime``
    holds (correlation id, call name, host start us), ``windows`` the
    frames' (start, end) ranges on the host. Returns the frames' events
    and the names of the records whose launch lies in no frame."""
    launched = {}
    for corr, call, start in runtime:
        f = _frame_at(windows, start)
        if f is not None:
            launched[corr] = (f, "GraphLaunch" in call)
    frames: List[List[Event]] = [[] for _ in windows]
    unassigned = []
    for corr, name, start, dur in device:
        if corr in launched:
            f, graph = launched[corr]
            frames[f].append((name, start, dur, graph))
        else:
            unassigned.append(name)
    return frames, unassigned


def profiled_events(prof, device: torch.device) -> Tuple[List[List[Event]], List[str]]:
    """The events of each frame of a finished ``torch.profiler`` run whose
    frames ran inside ``record_function(FRAME_LABEL)``, and the names of
    the records no frame launched: on the card the kernels and copies, each
    in the frame of its runtime call (``assign_by_correlation``); on the
    CPU the ops directly under a frame's range. Events of a name whose
    durations sum to zero are left out, as ``key_averages`` leaves them out
    of the device time."""
    from torch.autograd import DeviceType

    ranges = sorted((e for e in prof.events()
                     if e.name == FRAME_LABEL and e.device_type == DeviceType.CPU),
                    key=lambda e: e.time_range.start)
    windows = [(float(e.time_range.start), float(e.time_range.end)) for e in ranges]
    if device.type == "cuda":
        runtime, records = [], []
        for e in prof.events():
            if e.device_type == DeviceType.CPU and RUNTIME_CALL.match(e.name):
                runtime.append((e.id, e.name, float(e.time_range.start)))
            elif e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
                records.append((e.id, e.key, float(e.time_range.start),
                                float(e.time_range.end - e.time_range.start)))
        frames, unassigned = assign_by_correlation(records, runtime, windows)
    else:
        index = {id(e): i for i, e in enumerate(ranges)}
        frames, unassigned = [[] for _ in ranges], []
        for e in prof.events():
            parent = e.cpu_parent
            if e.device_type == DeviceType.CPU and parent is not None and id(parent) in index:
                frames[index[id(parent)]].append(
                    (e.key, float(e.time_range.start),
                     float(e.time_range.end - e.time_range.start), False))
    total = Counter()
    for group in frames:
        for name, _, dur, _ in group:
            total[name] += dur
    return [[e for e in group if total[e[0]] > 0] for group in frames], unassigned


@contextlib.contextmanager
def timed_replays():
    """While open, every ``torch.cuda.CUDAGraph.replay`` appends (host
    perf_counter s at its call, at its return, a CUDA event recorded just
    before it, one just after it) to the yielded list."""
    replay = torch.cuda.CUDAGraph.replay
    seen = []

    def timed(graph, *args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t0 = time.perf_counter()
        replay(graph, *args, **kwargs)
        t1 = time.perf_counter()
        end.record()
        seen.append((t0, t1, start, end))

    torch.cuda.CUDAGraph.replay = timed
    try:
        yield seen
    finally:
        torch.cuda.CUDAGraph.replay = replay


def trace(step: Callable[[], object], device: torch.device, frames: int = 8, top: int = 40,
          out: Optional[str] = None, warm: int = 3) -> dict:
    """``step()`` streams one frame. After ``warm`` frames, ``frames`` are
    timed on the host clock, each to a synchronize (on CUDA, where each
    frame replays one CUDA graph, also the replay: ``timed_replays``), then
    ``frames`` more run under ``torch.profiler`` after one warm-up frame,
    each in its own ``record_function`` range; returns ``aggregate``'s dict (with ``out``,
    the Chrome trace is written there)."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    cuda = device.type == "cuda"

    def frame():
        step()
        if cuda:
            torch.cuda.synchronize(device)

    for _ in range(warm):
        frame()
    wall, replays = [], []
    with timed_replays() if cuda else contextlib.nullcontext([]) as seen:
        for _ in range(frames):
            del seen[:]
            t0 = time.perf_counter()
            frame()
            wall.append((time.perf_counter() - t0) * 1e3)
            if cuda:
                if len(seen) != 1:
                    raise RuntimeError(f"trace_step: a frame made {len(seen)} graph replays, "
                                       "expected one")
                (r0, r1, start, end), = seen
                replays.append(((r0 - t0) * 1e3, (r1 - r0) * 1e3, start.elapsed_time(end)))
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=frames, repeat=1)) as prof:
        for _ in range(frames + 1):
            with record_function(FRAME_LABEL):
                frame()
            prof.step()
    if out:
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, f"trace_step-{os.getpid()}.json"))
    grouped, unassigned = profiled_events(prof, device)
    if len(grouped) != frames:
        raise RuntimeError(f"trace_step: {len(grouped)} frame ranges in the profile, "
                           f"{frames} frames run")
    result = aggregate(grouped, wall, top, replays or None, len(unassigned))
    result["unassigned_names"] = sorted(Counter(unassigned).items())[:10]
    return result


def report(result: dict, top: int, line: str) -> None:
    """Print ``aggregate``'s dict as the JAX tool prints its tables."""
    n = result["frames"]
    print(f"{result['kernels']:.2f} kernels and {result['device_ms']:.3f} ms of "
          f"{'device' if 'cpu' not in line else 'CPU op'} time a frame over {n} frames ({line})")
    for title, rows in (("top kernels", result["top"]), ("families (summed over shapes)",
                                                         result["families"]),
                        ("coarse buckets", result["buckets"])):
        print(f"\n{title}, ms a frame:")
        for name, (ms, launches) in list(rows.items())[:top]:
            print(f"{ms:10.3f} ms  x{launches:<8.2f} {name[:110]}")
    g = result["gaps"]
    print(f"\ngaps, p50 a frame: wall {g['wall_ms_p50']:.3f} ms = span {g['span_ms_p50']:.3f} "
          f"(busy {g['busy_ms_p50']:.3f}, idle inside {g['idle_in_span_ms_p50']:.3f}) "
          f"+ host {g['host_ms']:.3f}; the profiled span {g['profiled_span_ms_p50']:.3f}")
    if g["launch_ms_p50"] is not None:
        print(f"host before the replay {g['before_replay_ms_p50']:.3f} ms, inside it (the "
              f"graph's launch) {g['launch_ms_p50']:.3f} ms")
    for f, names in result["dropped_by_frame"].items():
        print(f"frame {f}: {sum(names.values())} records dropped from the trace: "
              + ", ".join(f"{family(k)[:50]} x{v}" for k, v in names.items()))
    if result["unassigned"]:
        print(f"{result['unassigned']} records launched in no frame: "
              f"{result['unassigned_names']}")
    print("gaps between events under the profiler, a frame (gaps, ms): " + ", ".join(
        f"{k} {n:.1f} {ms:.3f}" for k, (n, ms) in g["between_events"].items()))
    for gap, before, after in g["widest"]:
        print(f"{gap:10.1f} us between {family(before)[:50]} and {family(after)[:50]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="trace_step", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--steps", type=int, nargs="*", default=[30, 40])
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--out", default=None, help="directory for the Chrome trace")
    p.add_argument("--kv-cache", choices=["bf16", "int8"], default="int8")
    p.add_argument("--spatial-qk", choices=["bf16", "int8"], default="bf16")
    p.add_argument("--sessions", type=int, default=1,
                   help="trace MultiStream's round of S sessions instead of one stream's step")
    p.add_argument("--tiny", action="store_true", help="64x64, a narrow UNet, no depth model")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ._common import build_bench_pipeline, card_line, inputs

    built = build_bench_pipeline(args.device, args.height, args.width, args.steps,
                                 kv_cache=args.kv_cache, spatial_qk=args.spatial_qk,
                                 tiny=args.tiny)
    stream = built.stream
    s = args.sessions
    prompt, warm, clip = inputs(stream, 1, sessions=s)
    if s > 1:
        from ..stream.multi import MultiStream

        multi = MultiStream(stream, s)
        box = [multi.prepare(warm, prompt, seeds=list(range(s)))[0]]

        def step():
            box[0], _ = multi(box[0], clip[0])
    else:
        box = [stream.prepare(warm[0], prompt, seed=2)[0]]

        def step():
            box[0], _ = stream(box[0], clip[0, 0])

    result = trace(step, stream.device, args.frames, args.top, args.out)
    line = card_line(stream.device)
    report(result, args.top, line)
    print(json.dumps({"measured_on": line, **{k: result[k] for k in (
        "frames", "device_ms", "kernels", "kernels_by_frame", "kernels_full", "unassigned",
        "gaps")}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
