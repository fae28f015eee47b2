"""The port's spans, counters and device stages, and ``profile_trace``.

One process-wide ``Recorder`` (``RECORDER``) holds what the entry
(``wrapper.py``), the sessions layer (``stream/multi.py``) and the captured
step (``stream/graph.py``, ``stream/pipeline.py``) record as they run:

* spans: a name, start and end (``time.perf_counter_ns``), the parent span
  and the call they belong to. A root span (``root``) opens a call of its
  owner (a wrapper, a ``MultiStream``): its call id is the owner's call
  index, and every span opened inside it carries that call and owner. A
  span opened outside any root records nothing.
* device stages: the elapsed times between the CUDA events a captured step
  records at its stage boundaries (``STAGES``), read after the replay that
  recorded them has completed, filed under the call that replayed it. A
  step with the KL codec also records an event before and after each of
  its attentions; their spans, summed, are the stage ``CODEC_ATTN``.
* counters: plain integers (and seconds), by owner; 0 is the process.

Spans and stages go into bounded rings, preallocated, so memory does not
grow with frames: the span ring holds the last ``CALLS`` calls with up to
``SPANS_A_CALL`` spans each. There is no switch: recording is always on
and costs some tens of microseconds a call. While ``torch.profiler``
traces, each span also opens a ``record_function`` range of its name, so
the spans sit on the profiler's clock and in its Chrome trace
(``profile_trace``).

``summary(owner)`` is the operator's read-out (``StreamV2VWrapper.
trace_summary``); ``calls(...)`` gives the per-call records the benchmark's
per-layer metrics read.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import itertools
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

# the captured step's device stages, in the order the step runs them; the
# step records len(STAGES) + 1 events, one at each boundary
STAGES = ("device.depth", "device.encode", "device.unet", "device.scheduler", "device.decode")
# the KL codec's attentions, inside the encode and decode stages: after the
# boundary events a step records a (before, after) pair a call
CODEC_ATTN = "device.codec_attn"

CALLS = 4096  # calls the rings hold at least
SPANS_A_CALL = 16  # room a call has in the span ring (a frame of the wrapper opens 9)

_perf_ns = time.perf_counter_ns


def stage_events(device, count: int = len(STAGES) + 1) -> List["torch.cuda.Event"]:
    """``count`` timing events a captured step records: by default one at
    each stage boundary. ``external``: recorded during stream capture, each
    becomes an event-record node of the graph, recorded again at every
    replay. Each is recorded once here, outside any capture, so that it
    exists before the capture records it."""
    events = [torch.cuda.Event(enable_timing=True, external=True) for _ in range(count)]
    with torch.cuda.device(device):
        for e in events:
            e.record()
    return events


@dataclasses.dataclass
class CallRecord:
    """One call of an owner, as ``Recorder.calls`` gives it."""

    call: int
    start_ns: int
    end_ns: int
    spans: Dict[str, int]  # name of a span below the root -> its ns in this call, summed
    # device stage (``STAGES``, and ``CODEC_ATTN`` where recorded) -> ms, where read
    stages: Optional[Dict[str, float]]

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """``step_device_ms``: first stage event to last."""
        return None if self.stages is None else sum(self.stages[k] for k in STAGES)


def _libcuda() -> ctypes.CDLL:
    """``libcuda``, with ``cuEventElapsedTime`` declared."""
    global _LIBCUDA
    if _LIBCUDA is None:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuEventElapsedTime.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_void_p,
                                           ctypes.c_void_p]
        lib.cuEventElapsedTime.restype = ctypes.c_int
        _LIBCUDA = lib
    return _LIBCUDA


_LIBCUDA = None
_NOT_READY = 600  # CUDA_ERROR_NOT_READY


def elapsed_ms(events: Sequence["torch.cuda.Event"]) -> Optional[List[float]]:
    """ms from ``events[0]`` to each later event, or None where one has not
    completed. Straight to ``libcuda`` (``cuEventElapsedTime`` on the
    events' handles, which also says when an event is not complete): less
    host time than ``torch.cuda.Event``'s ``query`` and ``elapsed_time``."""
    lib = _libcuda()
    first, *rest = [e.cuda_event for e in events]
    out, ms = ctypes.c_float(), []
    for h in rest[::-1]:  # where one is not complete, none is read
        rc = lib.cuEventElapsedTime(ctypes.byref(out), first, h)
        if rc == _NOT_READY:
            return None
        if rc:
            raise RuntimeError(f"reading the stage events: CUresult {rc}")
        ms.append(out.value)
    return ms[::-1]


def _stage_ms(at: List[float]) -> tuple:
    """Each stage's ms from ``elapsed_ms``' times: the boundaries' steps,
    then, where the step recorded attention pairs after them, the pairs'
    spans summed (``CODEC_ATTN``)."""
    n = len(STAGES)
    ms = tuple(b - a for a, b in zip([0.0, *at[:n - 1]], at[:n]))
    pairs = at[n:]
    if pairs:
        ms += (sum(b - a for a, b in zip(pairs[::2], pairs[1::2])),)
    return ms


class _Span:
    __slots__ = ("rec", "name", "owner", "i", "stack", "rf")

    def __init__(self, rec: "Recorder", name: str, owner: Optional[int]):
        self.rec, self.name, self.owner = rec, name, owner

    def __enter__(self):
        rec = self.rec
        try:
            self.stack = stack = rec._local.stack  # (seq, call, owner) of each open span
        except AttributeError:
            self.stack = stack = rec._local.stack = []
        if self.owner is None:  # a child: of the innermost open span
            if not stack:
                self.i = -1
                return self
            parent, call, owner = stack[-1]
        else:  # a root: the owner's next call
            owner, parent = self.owner, -1
            call = rec._ncalls.get(owner, 0)
            rec._ncalls[owner] = call + 1
        rec._top = seq = next(rec._seq)
        self.i = i = seq % rec.capacity
        rec._name[i], rec._parent[i], rec._call[i], rec._owner[i] = self.name, parent, call, owner
        rec._end[i] = 0
        stack.append((seq, call, owner))
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = record_function(self.name)
            self.rf.__enter__()
        rec._start[i] = _perf_ns()
        return self

    def __exit__(self, *exc):
        end = _perf_ns()
        i = self.i
        if i < 0:
            return False
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec = self.rec
        rec._end[i] = end
        self.stack.pop()
        if self.owner is not None:  # a root: its EMA, which the wrapper's filter reads
            key = (self.owner, self.name)
            dt = (end - rec._start[i]) / 1e6
            ema = rec._ema.get(key)
            rec._ema[key] = dt if ema is None else rec.decay * ema + (1 - rec.decay) * dt
        return False


class Recorder:
    """Spans, device stages and counters in bounded rings (see the module's
    docstring). Spans nest per thread."""

    decay = 0.9  # of the EMAs

    def __init__(self):
        self.capacity = cap = CALLS * SPANS_A_CALL
        self.stage_capacity = CALLS
        self._name: List[Optional[str]] = [None] * cap
        self._start = [0] * cap
        self._end = [0] * cap  # 0 while the span is open
        self._parent = [-1] * cap  # the parent's sequence number, -1 for a root
        self._call = [-1] * cap
        self._owner = [0] * cap
        self._seq = itertools.count()
        self._top = -1  # the newest span's sequence number
        self._stages: List[Optional[tuple]] = [None] * CALLS  # (owner, call, stage ms)
        self._stage_seq = itertools.count()
        self._ncalls: Dict[int, int] = {}
        self._ema: Dict[tuple, float] = {}  # (owner, root span name) -> ms
        self._counters: Dict[tuple, List[float]] = {}  # (owner, name) -> [count, seconds]
        self._pending: Dict[int, tuple] = {}  # owner -> (call, events)
        self._owners = itertools.count(1)
        self._local = threading.local()

    # -- recording -------------------------------------------------------

    def owner(self) -> int:
        """A new owner id (0 is the process's)."""
        return next(self._owners)

    def root(self, name: str, owner: int) -> _Span:
        """A span that opens the owner's next call."""
        return _Span(self, name, owner)

    def span(self, name: str) -> _Span:
        """A span inside the innermost open span; nothing outside a root."""
        return _Span(self, name, None)

    def count(self, name: str, owner: int = 0, seconds: float = 0.0) -> None:
        c = self._counters.setdefault((owner, name), [0, 0.0])
        c[0] += 1
        c[1] += seconds

    def stages_pending(self, events: Optional[Sequence]) -> None:
        """A replay that records ``events`` was just launched in the
        innermost open call: ``read_stages`` reads them once it completes."""
        stack = getattr(self._local, "stack", None)
        if events is None or not stack:
            return
        _, call, owner = stack[-1]
        self._pending[owner] = (call, events)

    def read_stages(self, owner: int) -> None:
        """File the owner's pending stage times under the call that replayed
        them, if the replay has completed; count ``stage_reads_missed`` if
        it has not (they are dropped)."""
        pending = self._pending.pop(owner, None)
        if pending is None:
            return
        call, events = pending
        at = elapsed_ms(events)
        if at is None:
            self.count("stage_reads_missed", owner)
            return
        ms = _stage_ms(at)
        self._stages[next(self._stage_seq) % self.stage_capacity] = (owner, call, ms)

    # -- reading ---------------------------------------------------------

    def ema_s(self, owner: int, name: str) -> float:
        """The EMA of a root span's seconds; 0.0 before the first."""
        return self._ema.get((owner, name), 0.0) / 1e3

    def latest_owner(self) -> Optional[int]:
        """The owner of the newest root span in the ring."""
        n = self._top + 1
        for seq in range(n - 1, max(n - self.capacity, 0) - 1, -1):
            i = seq % self.capacity
            if self._parent[i] == -1 and self._name[i] is not None:
                return self._owner[i]
        return None

    def _closed(self, owner: int):
        """(index, sequence number) of the owner's closed spans in the ring,
        oldest first."""
        n = self._top + 1
        for seq in range(max(n - self.capacity, 0), n):
            i = seq % self.capacity
            if self._owner[i] == owner and self._end[i]:
                yield i, seq

    def calls(self, owner: Optional[int] = None, skip_first: int = 0,
              skip_last: int = 0) -> List[CallRecord]:
        """The owner's (default: the newest root's owner's) calls whose root
        span the ring holds, oldest first, leaving out calls with an id
        below ``skip_first`` and the last ``skip_last`` calls the owner
        opened."""
        owner = self.latest_owner() if owner is None else owner
        if owner is None:
            return []
        stop = self._ncalls.get(owner, 0) - skip_last
        roots: Dict[int, CallRecord] = {}
        below = []
        for i, _ in self._closed(owner):
            call = self._call[i]
            if not skip_first <= call < stop:
                continue
            if self._parent[i] == -1:
                roots[call] = CallRecord(call, self._start[i], self._end[i], {}, None)
            else:
                below.append((call, self._name[i], self._end[i] - self._start[i]))
        for call, name, ns in below:
            if call in roots:
                spans = roots[call].spans
                spans[name] = spans.get(name, 0) + ns
        for entry in self._stages:
            if entry is not None and entry[0] == owner and entry[1] in roots:
                roots[entry[1]].stages = dict(zip(STAGES + (CODEC_ATTN,), entry[2]))
        return [roots[c] for c in sorted(roots)]

    def summary(self, owner: int) -> dict:
        """Per span name and per device stage of ``owner``'s calls in the
        rings: count, and the ms's median, p95, mean, std (the first call
        left out where there are later ones: it may pay builds and a
        capture) and EMA, and a span's median self time (its ms less its
        children's); and the counters, the owner's with the process's."""
        closed = list(self._closed(owner))
        inner: Dict[int, int] = {}  # a span's sequence number -> its children's ns
        for i, _ in closed:
            if self._parent[i] != -1:
                p = self._parent[i]
                inner[p] = inner.get(p, 0) + self._end[i] - self._start[i]
        samples: Dict[str, List[tuple]] = {}
        selfs: Dict[str, List[tuple]] = {}
        for i, seq in closed:
            ns = self._end[i] - self._start[i]
            samples.setdefault(self._name[i], []).append((self._call[i], ns / 1e6))
            selfs.setdefault(self._name[i], []).append(
                (self._call[i], (ns - inner.get(seq, 0)) / 1e6))
        stages: Dict[str, List[tuple]] = {}
        for entry in self._stages:
            if entry is not None and entry[0] == owner:
                for name, ms in zip(STAGES + (CODEC_ATTN,), entry[2]):
                    stages.setdefault(name, []).append((entry[1], ms))

        def sample(pairs):
            return np.asarray([ms for call, ms in pairs if call > 0] or [ms for _, ms in pairs])

        def stats(pairs):
            arr = sample(pairs)
            ema = None
            for _, ms in sorted(pairs):  # in call order: the stage ring is read by slot
                ema = ms if ema is None else self.decay * ema + (1 - self.decay) * ms
            return {"count": len(pairs), "median_ms": float(np.median(arr)),
                    "p95_ms": float(np.percentile(arr, 95)), "mean_ms": float(arr.mean()),
                    "std_ms": float(arr.std()), "ema_ms": ema}

        counters = {"calls": self._ncalls.get(owner, 0)}
        for (who, name), (n, s) in sorted(self._counters.items()):
            if who in (0, owner):
                counters[name] = counters.get(name, 0) + n
                if name in ("captures", "kernel_loads"):
                    counters[f"{name}_s"] = counters.get(f"{name}_s", 0.0) + s
        spans = {k: stats(v) for k, v in samples.items()}
        for k, v in spans.items():
            v["self_median_ms"] = float(np.median(sample(selfs[k])))
        return {"spans": spans,
                "stages": {k: stats(v) for k, v in stages.items()},
                "counters": counters}


RECORDER = Recorder()


def with_routes(summary: dict) -> dict:
    """``summary`` with the process's norm calls by route
    (``ops/norm.py:norm_route_counts``) and the KL codec's GroupNorms and
    attentions (``models/vae.py:codec_route_counts``) among its counters,
    and ``conv_weight_relayouts`` (``models/resnet.py:count_weight_relayout``)
    at 0 where no conv counted one."""
    from ..models.vae import codec_route_counts
    from ..ops.norm import norm_route_counts

    summary["counters"].setdefault("conv_weight_relayouts", 0)
    summary["counters"]["norm_routes"] = dict(norm_route_counts)
    summary["counters"]["codec_routes"] = dict(codec_route_counts)
    return summary


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block, CPU and (where there is a card)
    CUDA activity, its Chrome trace written into ``log_dir`` as
    ``trace-<pid>-<ns>.json``; the recorder's spans are in it as
    ``record_function`` ranges. Yields the profiler, or None and records
    nothing for a falsy ``log_dir``."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
