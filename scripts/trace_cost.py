"""What the port's recorder (``live2diff_tpu_torch/utils/timing.py``) costs
on the card, in one process.

* host: one wrapper call's spans, its pending stage events and their read
  (``read_stages``: a query and five elapsed times), with no work inside,
  in microseconds a call; once without a profiler (the cost that is always
  on) and once under ``torch.profiler`` (each span then also opens a
  ``record_function`` range); and split: the spans alone, and the read
  alone;
* device: the six stage-event nodes of the captured step. bench.py's
  512x512 pipeline (bf16 KV cache, depth, random weights) captures the step
  of one state with its stage events and of another without them; the two
  graphs replay in turns, back to back, timed by CUDA events outside the
  graphs: ms a replay each, and the difference in microseconds. The stage
  times a replay reads are printed beside the replay's time.

    python3 scripts/trace_cost.py [--calls 20000] [--replays 40] [--rounds 6] [--json OUT]

Needs a card. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from live2diff_tpu_torch.tools._common import build_bench_pipeline, card_line  # noqa: E402
from live2diff_tpu_torch.utils import timing  # noqa: E402
from live2diff_tpu_torch.utils.timing import STAGES, Recorder, stage_events  # noqa: E402


def wrapper_call(rec: Recorder, owner: int, events) -> None:
    """The recorder's part of one ``StreamV2VWrapper.img2img`` on the card."""
    with rec.root("wrapper.img2img", owner):
        with rec.span("wrapper.preprocess"):
            pass
        with rec.span("stream.step"):
            with rec.span("stream.upload"):
                pass
            with rec.span("stream.replay"):
                pass
            rec.stages_pending(events)
            with rec.span("stream.clone"):
                pass
        with rec.span("wrapper.sync"):
            pass
        rec.read_stages(owner)
        with rec.span("wrapper.fetch"):
            pass
        with rec.span("wrapper.postprocess"):
            pass


def host_us(calls: int, events) -> float:
    rec = Recorder()
    owner = rec.owner()
    for _ in range(100):
        wrapper_call(rec, owner, events)
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        wrapper_call(rec, owner, events)
    return (time.perf_counter_ns() - t0) / calls / 1e3


def read_us(calls: int, events) -> float:
    for _ in range(100):
        timing.elapsed_ms(events)
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        timing.elapsed_ms(events)
    return (time.perf_counter_ns() - t0) / calls / 1e3


def host_us_profiled(calls: int, events) -> float:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        return host_us(calls, events)


def replay_ms(graph, replays: int) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--calls", type=int, default=20000)
    p.add_argument("--replays", type=int, default=40)
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_cost: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out = {"card": card_line(dev)}

    events = stage_events(dev)
    torch.cuda.synchronize()
    out["host_us_a_call"] = host_us(args.calls, events)
    out["host_us_spans_only"] = host_us(args.calls, None)
    out["read_us"] = read_us(args.calls, events)
    out["host_us_a_call_profiled"] = host_us_profiled(max(args.calls // 10, 100), events)

    built = build_bench_pipeline(dev, kv_cache="bf16")
    stream = built.stream
    rng = np.random.RandomState(0)
    warm = torch.from_numpy(rng.randint(0, 256, (8, 512, 512, 3), dtype=np.uint8))
    prompt = torch.randn(1, 77, 768, generator=torch.Generator().manual_seed(0))
    marked, _ = stream.prepare(warm, prompt, seed=1)
    plain, _ = stream.prepare(warm, prompt, seed=2)
    stream.warm_frame_step(torch.uint8)
    stream.capture_step(marked, torch.uint8)
    stream.stage_marks = lambda: contextlib.nullcontext(None)  # the parent's capture
    stream.capture_step(plain, torch.uint8)
    del stream.stage_marks
    g_marked = stream._graphs.find(marked, torch.uint8)
    g_plain = stream._graphs.find(plain, torch.uint8)
    assert g_marked.events is not None and g_plain.events is None
    for g in (g_marked, g_plain):
        replay_ms(g.graph, 3)

    times = {"marked": [], "plain": []}
    for r in range(args.rounds):
        order = (("marked", g_marked), ("plain", g_plain))
        for name, g in order if r % 2 == 0 else order[::-1]:
            times[name].append(replay_ms(g.graph, args.replays))
    rec = Recorder()
    owner = rec.owner()
    with rec.root("replay", owner):
        g_marked.graph.replay()
        rec.stages_pending(g_marked.events)
    torch.cuda.synchronize()
    rec.read_stages(owner)
    (call,) = rec.calls(owner)
    out.update(
        replay_ms={k: statistics.median(v) for k, v in times.items()},
        replay_ms_each=times,
        event_nodes_us_a_step=1e3 * statistics.median(
            [m - q for m, q in zip(times["marked"], times["plain"])]),
        stages_ms=call.stages, step_device_ms=call.device_ms)
    out["event_nodes_share_pct"] = (100.0 * out["event_nodes_us_a_step"] / 1e3
                                    / out["replay_ms"]["plain"])
    assert list(call.stages) == list(STAGES)
    line = json.dumps(out)
    if args.json:
        Path(args.json).write_text(line + "\n")
    print(line, flush=True)
    stream.release_graphs()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
