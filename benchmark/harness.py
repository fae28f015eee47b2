"""One run of one cell: set-up, the timed window, the trace, the check.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration file, the configuration's reference module where the
file names one (``"reference": "<file>.py"``, under ``reference/``: its
models, their codec and their work counts; see ``reference/stream.py``),
its traffic file (``workloads/<traffic>.json``), its check file
(``checks/<cell>.json``: how many outputs are compared and the limit of
each number) and each per-layer metric's reader (``metrics/<name>.py``, a
``read(ctx)`` that returns a number or None).

The system under test is ``live2diff_tpu_torch``, driven through the
entries the demo server drives: ``StreamV2VWrapper.img2img`` for one
stream (``"entry": "wrapper"``), one ``MultiStream`` over the wrapper's
stream for several (``"entry": "multistream"``). Each session runs a
closed loop: its next frame goes in when its previous call has returned
its output on the host as uint8.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import random
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import peaks as peaks_table  # noqa: E402
import tracemath as tr  # noqa: E402
import traffic as traffic_gen  # noqa: E402
import weights as weights_mod  # noqa: E402
import work  # noqa: E402
from reference import stream as ref_stream  # noqa: E402
from reference.models import set_low  # noqa: E402

CALL_LABEL = "bench.call"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict  # the configuration file
    traffic: dict  # the traffic file
    check: dict  # the check file
    bench: Path  # the benchmark's folder

    @property
    def lag(self) -> int:
        """Calls between a frame's input and the output that carries it."""
        return len(self.cfg["t_index_list"]) - 1


def reference_file(bench: Path, name: str) -> Path:
    """The reference module a configuration names: a ``.py`` file directly
    under the benchmark's ``reference/`` folder."""
    path = bench / "reference" / name
    if Path(name).name != name or path.suffix != ".py" or not path.is_file():
        raise ValueError(f"reference {name!r}: expected the name of a .py file in {path.parent}")
    return path


def find_cell(root: Path, name: str) -> tuple:
    """(the cell, BENCHMARK.json) of the cell ``name`` under ``root``."""
    spec = load_json(root / "BENCHMARK.json")
    bench = root / spec["paths"][0]
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{[w['name'] for w in spec['workloads']]}")
    config = next(c for c in spec["configs"] if c["name"] == entry["config"])
    cfg = load_json(root / config["file"])
    if "reference" in cfg:
        cfg["reference"] = str(reference_file(bench, cfg["reference"]))
    cell = Cell(name=name, cfg=cfg,
                traffic=load_json(bench / "workloads" / f"{entry['traffic']}.json"),
                check=load_json(bench / "checks" / f"{name}.json"), bench=bench)
    return cell, spec


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def served_dtype(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["dtype"])


def prompts(cell: Cell, seed: int, device) -> List[torch.Tensor]:
    """One ``[1, L, D]`` prompt embedding a session, in the served dtype."""
    out = []
    for s in range(cell.traffic["sessions"]):
        g = torch.Generator(device=device).manual_seed(traffic_gen.seed_for(seed, "prompt", s))
        out.append(torch.randn(cell.cfg["prompt_shape"], generator=g, device=device,
                               dtype=served_dtype(cell.cfg)))
    return out


def noise_seeds(cell: Cell, seed: int) -> List[int]:
    return [traffic_gen.seed_for(seed, "noise", s) for s in range(cell.traffic["sessions"])]


def frames(cell: Cell, seed: int, device):
    """(warmup frames, frame pool) a session, uint8 numpy."""
    pairs = [traffic_gen.session_frames(cell.traffic, seed, s, device)
             for s in range(cell.traffic["sessions"])]
    return [w for w, _ in pairs], [p for _, p in pairs]


# ---------------------------------------------------------------------------
# the system under test
# ---------------------------------------------------------------------------


def wrapper_kwargs(cell: Cell, seed: int, device: str, root: Path) -> dict:
    cfg, t = cell.cfg, cell.traffic
    unet = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["unet"].items()
            if k != "mapping_channels"}
    sched = {k: cfg["scheduler"][k] for k in ("num_train_timesteps", "beta_start", "beta_end",
                                              "beta_schedule", "steps_offset", "clip_sample")}
    config = {"num_inference_steps": cfg["num_inference_steps"],
              "t_index_list": list(cfg["t_index_list"]), "noise_scheduler_kwargs": sched}
    return dict(config_path=config, num_inference_steps=cfg["num_inference_steps"],
                t_index_list=list(cfg["t_index_list"]), output_type="np",
                height=t["height"], width=t["width"], use_tiny_vae=cfg["use_tiny_vae"],
                use_depth=cfg["use_depth"], use_text_encoder=False,
                seed=noise_seeds(cell, seed)[0], engine_dir=str(root / "build" / "bench_engines"),
                dtype=cfg["dtype"], unet_overrides=unet, kv_cache_dtype=cfg["kv_cache_dtype"],
                device=device)


def program_parameters(built) -> Dict[str, Dict[str, torch.Tensor]]:
    models = {"unet": built.unet, "vae": built.vae}
    if built.depth_model is not None:
        models["depth"] = built.depth_model
    return {k: dict(m.named_parameters()) for k, m in models.items()}


def fill_program(built, cfg: dict, seed: int) -> None:
    """The benchmark's weights into the program's parameters, in place,
    after checking that the program holds exactly the configuration's
    parameters by name and shape."""
    shapes = ref_stream.shapes(cfg)
    params = program_parameters(built)
    want = {(m, n): s for m, n, s in shapes}
    have = {(m, n): tuple(p.shape) for m, ps in params.items() for n, p in ps.items()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))[:8]
        raise RuntimeError(f"the program's parameters differ from the configuration's: {diff}")
    weights_mod.fill(shapes, traffic_gen.seed_for(seed, "weights"), served_dtype(cfg),
                     next(iter(params["unet"].values())).device, params)


class WrapperEntry:
    """One stream through ``StreamV2VWrapper.img2img`` (np uint8 out)."""

    def __init__(self, wrapper, prompt: torch.Tensor, warm: np.ndarray):
        self.wrapper = wrapper
        wrapper.encode_prompt = lambda _text: prompt  # the embedding in place of CLIP
        wrapper.prepare("", warm)

    def __call__(self, frames: Sequence[np.ndarray]) -> List[np.ndarray]:
        return [self.wrapper.img2img(frames[0])]

    def close(self) -> None:
        self.wrapper.stream.release_graphs()


class MultiEntry:
    """S sessions through one ``MultiStream`` over the wrapper's stream, one
    batched round a call, as the demo server's batched pipeline runs them."""

    def __init__(self, wrapper, prompts_: List[torch.Tensor], warm: List[np.ndarray],
                 seeds: List[int]):
        from live2diff_tpu_torch.stream.multi import MultiStream

        self.wrapper = wrapper
        dev = wrapper.stream.device
        self.multi = MultiStream(wrapper.stream, len(prompts_),
                                 prompt_len=prompts_[0].shape[1])
        self.states, _ = self.multi.prepare(torch.from_numpy(np.stack(warm)).to(dev),
                                            torch.cat(prompts_), seeds=seeds)

    def __call__(self, frames: Sequence[np.ndarray]) -> List[np.ndarray]:
        self.states, out = self.multi(self.states, np.stack(frames))
        return list(out.cpu().numpy())

    def close(self) -> None:
        self.multi.release_graphs()
        self.wrapper.stream.release_graphs()


def build_entry(cell: Cell, seed: int, device: str, root: Path, warm, prompts_,
                stages: Dict[str, float]):
    """The cell's entry, built, filled and prepared; the seconds of each
    stage into ``stages``."""
    t0 = time.perf_counter()
    from live2diff_tpu_torch.wrapper import StreamV2VWrapper

    stages["program import"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wrapper = StreamV2VWrapper(**wrapper_kwargs(cell, seed, device, root))
    stages["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fill_program(wrapper.built, cell.cfg, seed)
    stages["weights"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kind = cell.traffic["entry"]
    if kind == "wrapper":
        entry = WrapperEntry(wrapper, prompts_[0], warm[0])
    elif kind == "multistream":
        entry = MultiEntry(wrapper, prompts_, warm, noise_seeds(cell, seed))
    else:
        raise ValueError(f"traffic entry {kind!r}: expected 'wrapper' or 'multistream'")
    stages["prepare and capture"] = time.perf_counter() - t0
    return entry


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Window:
    starts: List[float]
    ends: List[float]
    kept: List[List[np.ndarray]]  # the first compared calls' outputs, by session
    failed: int

    @property
    def seconds(self) -> float:
        return self.ends[-1] - self.starts[0]


def frames_at(pools, j: int) -> List[np.ndarray]:
    return [p[j % len(p)] for p in pools]


def valid(out, traffic: dict) -> bool:
    return (isinstance(out, np.ndarray) and out.dtype == np.uint8
            and out.shape == (traffic["height"], traffic["width"], 3))


def run_window(entry, pools, cell: Cell, seconds: float, first: int) -> Window:
    """Closed-loop calls from call index ``first`` until ``seconds`` have
    passed since the first one began."""
    keep = cell.check["compare_calls"]
    w = Window([], [], [], 0)
    j = first
    while True:
        fr = frames_at(pools, j)
        t0 = time.perf_counter()
        outs = entry(fr)
        t1 = time.perf_counter()
        w.starts.append(t0)
        w.ends.append(t1)
        w.failed += sum(not valid(o, cell.traffic) for o in outs) + len(fr) - len(outs)
        if len(w.kept) < keep:
            w.kept.append(outs)
        j += 1
        if t1 - w.starts[0] >= seconds:
            return w


def latencies_ms(w: Window, lag: int, sessions: int) -> List[float]:
    """A frame's input to the output that carries it, ``lag`` calls later,
    for every frame whose output came within the window."""
    return [1e3 * (w.ends[j + lag] - w.starts[j]) for j in range(len(w.starts) - lag)
            for _ in range(sessions)]


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TraceContext:
    """What a per-layer metric's reader reads."""

    calls: List[List[tr.Event]]  # each profiled call's device records
    window_us: float  # the profiled calls' wall time, first start to last end
    busy_us: float  # the part of it some device record covers
    fps: float  # frames a second over the unprofiled window
    cfg: dict
    traffic: dict
    peaks: Optional[Dict[str, float]]
    work = work
    trace = tr


def trace_calls(entry, pools, first: int, count: int, cuda: bool):
    """``count`` calls under ``torch.profiler`` (after one warm-up call),
    each in a ``record_function`` range: (each call's device records, the
    calls' host ranges, the host ops as (name, start us, end us))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=count, repeat=1)) as prof:
        for k in range(count + 1):
            with record_function(CALL_LABEL):
                entry(frames_at(pools, first + k))
            prof.step()
    events = prof.events()
    ranges = sorted((e for e in events if e.name == CALL_LABEL
                     and e.device_type == DeviceType.CPU), key=lambda e: e.time_range.start)
    windows = [(float(e.time_range.start), float(e.time_range.end)) for e in ranges]
    host, runtime, records = [], [], []
    for e in events:
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CPU:
            host.append((e.name, start, end))
            if tr.RUNTIME_CALL.match(e.name):
                runtime.append((e.id, e.name, start))
        elif e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            records.append((e.id, e.name, start, end - start))
    if cuda:
        calls, _ = tr.assign_by_correlation(records, runtime, windows)
    else:  # a rehearsal: the host ops directly under each call stand in
        index = {id(e): i for i, e in enumerate(ranges)}
        calls = [[] for _ in ranges]
        for e in events:
            parent = e.cpu_parent
            if e.device_type == DeviceType.CPU and parent is not None and id(parent) in index:
                calls[index[id(parent)]].append(
                    (e.name, float(e.time_range.start),
                     float(e.time_range.end - e.time_range.start), False))
    return calls, windows, host


def breakdown(calls, windows, host) -> dict:
    flat = [e for group in calls for e in group]
    by_op = tr.totals_us(calls, lambda n: f"{tr.bucket(n)} | {tr.family(n)}")
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = tr.idle_gaps(flat, windows[0][0], windows[-1][1])
    return {"device_ops": [[k, v / 1e6] for k, v in top],
            "idle_gaps": tr.label_gaps(gaps, host)}


def per_layer(cell: Cell, spec: dict, ctx: TraceContext) -> Dict[str, dict]:
    """Every per-layer metric of ``BENCHMARK.json`` that this cell reports,
    each from its reader; a reader that finds nothing leaves it out."""
    out = {}
    for m in spec["per_layer"]:
        if "workloads" in m and cell.name not in m["workloads"]:
            continue
        path = cell.bench / "metrics" / f"{m['name']}.py"
        mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{m['name']}", path)
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
        value = module.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------


def checked_sessions(cell: Cell, seed: int) -> List[int]:
    """The sessions the check follows: all, or the check file's
    ``compare_sessions`` of them drawn from the seed."""
    sessions = list(range(cell.traffic["sessions"]))
    k = cell.check.get("compare_sessions", len(sessions))
    return sorted(random.Random(traffic_gen.seed_for(seed, "check")).sample(sessions, k))


def reference_outputs(cell: Cell, seed: int, calls: int, device, warm, pools,
                      prompts_: List[torch.Tensor]) -> Dict[int, List[torch.Tensor]]:
    """The plain reference's outputs of calls 0..``calls``-1 of each checked
    session, each followed alone from its warmup, in fp32 with TF32 off."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        modules = ref_stream.build(cell.cfg, device)
        params = {k: dict(m.named_parameters()) for k, m in modules.items()}
        weights_mod.fill(ref_stream.shapes(cell.cfg), traffic_gen.seed_for(seed, "weights"),
                         served_dtype(cell.cfg), device, params)
        t = cell.traffic
        out = {}
        for s in checked_sessions(cell, seed):
            stream = ref_stream.RefStream(cell.cfg, modules, t["height"], t["width"],
                                          noise_seeds(cell, seed)[s], device)
            stream.prepare(torch.from_numpy(warm[s]), prompts_[s])
            out[s] = [stream.step(torch.from_numpy(frames_at(pools, j)[s])).cpu()
                      for j in range(calls)]
            del stream
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def compare(program: Sequence[Sequence[np.ndarray]], reference: Sequence[Sequence]) -> dict:
    """Numbers of the program's frames against the reference's, uint8
    levels: ``frame_rms_max`` the largest RMS difference of a frame,
    ``frame_rms_median`` the median frame's, ``frame_maxabs`` the largest
    difference of a pixel, ``ref_std`` the reference frames' spread."""
    rms, maxabs, std = [], 0.0, []
    for p_frames, r_frames in zip(program, reference):
        for p, r in zip(p_frames, r_frames):
            d = p.astype(np.float64) - np.asarray(r, dtype=np.float64)
            rms.append(float(np.sqrt(np.mean(d * d))))
            maxabs = max(maxabs, float(np.abs(d).max()))
            std.append(float(np.asarray(r, dtype=np.float64).std()))
    return {"frame_rms_max": max(rms), "frame_rms_median": statistics.median(rms),
            "frame_maxabs": maxabs, "ref_std": statistics.median(std), "frames": len(rms)}


def judged(numbers: dict, limits: Dict[str, Optional[float]]) -> Dict[str, dict]:
    return {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_cell(root: Path, name: str, seed: int, seconds: float, traced: bool, device: str,
             t_process: float, log=print) -> dict:
    """One run of cell ``name``: the result line's fields. ``device`` is
    "cuda" (a measurement) or "cpu" (a rehearsal at the configuration's
    sizes on the host, whose numbers are no device measurement and go under
    ``rehearsal_metrics``)."""
    cell, spec = find_cell(root, name)
    cuda = device == "cuda"
    dev = torch.device(device)
    t = cell.traffic
    stages = {"imports": time.perf_counter() - t_process}
    t0 = time.perf_counter()
    warm, pools = frames(cell, seed, dev)
    prompts_ = prompts(cell, seed, dev)
    stages["inputs"] = time.perf_counter() - t0
    entry = build_entry(cell, seed, device, root, warm, prompts_, stages)
    t0 = time.perf_counter()
    for j in range(t["setup_calls"]):
        entry(frames_at(pools, j))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    stages["setup calls"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_process
    log("[bench] set-up s: " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    first = t["setup_calls"]
    win = run_window(entry, pools, cell, seconds, first)
    sessions = t["sessions"]
    frames_out = len(win.starts) * sessions
    fps = frames_out / win.seconds
    lat = latencies_ms(win, cell.lag, sessions)
    log(f"[bench] {name}: {len(win.starts)} calls, {frames_out} frames in {win.seconds:.3f} s; "
        f"latency samples {len(lat)}")
    call_ms = [1e3 * (b - a) for a, b in zip(win.starts, win.ends)]
    half = len(call_ms) // 2
    log("[bench] call ms p50, first half / second half: "
        f"{statistics.median(call_ms[:half] or call_ms):.3f} / "
        f"{statistics.median(call_ms[half:]):.3f}")
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu", "count": 1}
    result: Dict[str, object] = {}
    if traced:
        after = first + len(win.starts)
        calls, windows, host = trace_calls(entry, pools, after, t["trace_calls"], cuda)
        flat = [e for group in calls for e in group]
        window_us = windows[-1][1] - windows[0][0]
        ctx = TraceContext(calls=calls, window_us=window_us, busy_us=tr.union_us(flat),
                           fps=fps, cfg=cell.cfg, traffic=t,
                           peaks=peaks_table.peaks_for(dev_info["kind"]) if cuda else None)
        metrics = per_layer(cell, spec, ctx)
        dev_info.update(busy_s=ctx.busy_us / 1e6, window_s=window_us / 1e6)
        result["breakdown"] = breakdown(calls, windows, host)
    else:
        metrics = {"fps": {"value": fps, "unit": "frames/s"},
                   "latency_ms_p95": {"value": float(np.percentile(lat, 95)), "unit": "ms"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {k: v for k, v in metrics.items() if _reported(spec, cell, k)}
    dev_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    entry.close()
    del entry
    free_device()
    compared = min(cell.check["compare_calls"], len(win.kept))
    t0 = time.perf_counter()
    ref = reference_outputs(cell, seed, first + compared, dev, warm, pools, prompts_)
    program = [[win.kept[j][s] for j in range(compared)] for s in ref]
    numbers = compare(program, [r[first:first + compared] for r in ref.values()])
    log(f"[bench] reference: {numbers['frames']} frames compared in "
        f"{time.perf_counter() - t0:.1f} s; reference spread {numbers['ref_std']:.3f} levels")
    limits = cell.check["limits"]
    check = judged(numbers, limits)
    correct = win.failed == 0 and numbers["frames"] > 0 and all(
        c["limit"] is None or c["value"] <= c["limit"] for c in check.values())
    result.update(correct=bool(correct), attempted=frames_out, failed=win.failed,
                  metrics=metrics, device=dev_info)
    if not cuda:
        result["rehearsal_metrics"] = result.pop("metrics")
    result["check"] = check
    return result


def _reported(spec: dict, cell: Cell, metric: str) -> bool:
    m = next((m for m in spec["end_to_end"] if m["name"] == metric), None)
    return m is not None and ("workloads" not in m or cell.name in m["workloads"])


def control(root: Path, name: str, seed: int, low_dtype, device: str) -> dict:
    """The control: the reference in ``low_dtype`` products put in the
    program's place over the cell's inputs and compared calls, judged as
    a run's outputs are. No window: the compared calls alone."""
    cell, _ = find_cell(root, name)
    dev = torch.device(device)
    warm, pools = frames(cell, seed, dev)
    prompts_ = prompts(cell, seed, dev)
    first = cell.traffic["setup_calls"]
    n = first + cell.check["compare_calls"]
    t0 = time.perf_counter()
    ref = reference_outputs(cell, seed, n, dev, warm, pools, prompts_)
    ref_s = time.perf_counter() - t0
    set_low(low_dtype)
    try:
        low = reference_outputs(cell, seed, n, dev, warm, pools, prompts_)
    finally:
        set_low(None)
    program = [[np.asarray(f) for f in r[first:]] for r in low.values()]
    numbers = compare(program, [r[first:] for r in ref.values()])
    numbers["reference_s"] = ref_s
    return numbers
