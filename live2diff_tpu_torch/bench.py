"""Benchmark of the port: streaming fps of the full pipeline on one card.
The counterpart of ``bench.py``, with its flags, rows and JSON keys.

    python -m live2diff_tpu_torch.bench                  # on the card
    python -m live2diff_tpu_torch.bench --tiny --device cpu --frames 4 --budget 0

Measures what ``bench.py`` measures: frames a second through the whole
streaming step (preprocess -> TAESD encode -> DPT-hybrid depth ->
stream-batch UNet -> LCM -> decode) at 512x512, 2 LCM steps, uint8 frames
in and out, the served settings (int8 KV cache, bf16 spatial QK), random
weights from seed 0 (no checkpoints here; the work and the shapes are the
real model's).

Protocols (``--protocol``):

* ``device`` (default): the 16 frames uploaded first, then chains of
  ``--chain`` steps ``stream(state, frame)`` (one CUDA graph replay each),
  each chain ending in one ``torch.cuda.synchronize()``; a frame's time is
  the chain's wall time over its length. The headline is the p50 of the
  chains; their mean and spread are beside it. What the chain leaves out,
  the upload of a uint8 frame and the fetch of the output, is measured
  apart, each synchronised (``upload_ms``, ``fetch_ms``,
  ``fps_mean_with_io``).
* ``sync``: one synchronised step a frame.
* ``pipelined``: ``PipelinedStream`` windows over host frames.

After the headline, the optional rows in order of priority, each gated on
the budget (``--budget``, ``LIVE2DIFF_BENCH_BUDGET_S``, default 1450 s) by
its cost estimated from this run's own times (``phase_ok``): the AOT prime
(``aot.save_engines`` when ``aot.load_engines`` missed), the burst
(``stream_burst`` of ``--chain`` frames), the serving window
(``PipelinedStream``), 4 sessions (``MultiStream``: synchronised chains of
rounds, then ``PipelinedStream`` over the rounds), the int8 cache against a
bf16 one (PSNR and SNR over ``--psnr-frames``), the 768x512 row and the
kernel selftest (``tools/kernel_check.run_all(quick=True)``). The JSON line
is printed as soon as the headline exists and again after every row; on
SIGTERM the bench prints it and exits 0, or 124 if there is no headline
yet. The last line of stdout is the result; stage lines go to stderr.

What does not carry over from ``bench.py``, and why:

* its child processes (``orchestrate``): the TPU backend allows one device
  session a chip, so each group of rows ran in a process of its own. CUDA
  has no such rule: every row runs in this process. Before the next
  pipeline is built the previous one is freed (its captured graphs
  released, ``del``, ``gc.collect()``, ``torch.cuda.empty_cache()``), and
  each row's peak device memory is printed on its stage line. The hidden
  flags that carried a row's outputs from one of those processes to the
  other (``--psnr-dump``, ``--int8-dump``) went with them.
* ``_recover_reexec``: it works around a poisoned XLA compilation cache;
  the port has no such cache.

A row that fails is recorded as ``None`` (``"error"`` for the selftest), as
``bench.py`` records it, and the rest go on; no row is ever run on the CPU
or with the plain kernels in its place. ``--device cuda`` (the default)
without a card exits non-zero. ``--tiny`` is the CPU smoke of
``bench.py:616-627``: its tiny UNet at 64x64, fp32, no depth model, whose
head widths the card's kernels do not take (run it with ``--device cpu``).

One fix over ``bench.py``: the 768x512 row's burst is read under the key
the chain length gives it (``fps_burst{chain}``), where ``bench.py:509``
reads ``fps_burst10`` whatever ``--chain`` is.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import signal
import sys
import time
from typing import Optional

import numpy as np

# the original's speed table (SURVEY.md section 6): TensorRT on an RTX 4090
_BASELINES = {(512, 512): 16.43, (768, 512): 12.15}
BASELINE_FPS = 16.43  # 512x512, 2 steps
PROMPT = "masterpiece, best quality, a benchmark"
# the stage line with the hand kernels' launches a step (counted at capture)
LAUNCHES_TAG = "kernel launches a step, counted at capture: "
SESSIONS = 4  # the sessions row

_T0 = time.time()
_BUDGET_S = float(os.environ.get("LIVE2DIFF_BENCH_BUDGET_S", "1450"))
# the result so far, which emit() prints and the SIGTERM handler reads
_RESULT: dict = {}


def stage(msg: str) -> None:
    print(f"# [{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def remaining() -> float:
    return _BUDGET_S - (time.time() - _T0)


def emit() -> None:
    """Print the result line (the last one printed is the result)."""
    if "value" in _RESULT:
        print(json.dumps(_RESULT), flush=True)


def _on_term(signum, frame):  # noqa: ANN001
    stage(f"signal {signum}: printing the current result and exiting")
    emit()
    sys.exit(0 if "value" in _RESULT else 124)


def phase_ok(name: str, est_s: float, slack_s: float = 45.0) -> bool:
    """True if the optional row fits the remaining budget; else records it
    in ``skipped_rows``."""
    r = remaining()
    if r < est_s + slack_s:
        stage(f"skip {name}: est {est_s:.0f}s > remaining {r:.0f}s of {_BUDGET_S:.0f}s budget")
        _RESULT.setdefault("skipped_rows", []).append(name)
        return False
    return True


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m live2diff_tpu_torch.bench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--warmup-iters", type=int, default=4)
    p.add_argument("--tiny", action="store_true",
                   help="CPU smoke: bench.py's tiny UNet at 64x64, fp32, no depth model")
    p.add_argument("--no-depth", action="store_true")
    p.add_argument("--protocol", choices=["device", "pipelined", "sync"], default="device",
                   help="device (default): chains of steps, one synchronize a chain; "
                        "pipelined: PipelinedStream windows; sync: one synchronised step "
                        "a frame")
    p.add_argument("--chain", type=int, default=10,
                   help="device protocol: steps a chain, between synchronizes")
    p.add_argument("--sync", action="store_true", help="alias for --protocol sync")
    p.add_argument("--no-serving-window", action="store_true",
                   help="device protocol: skip the PipelinedStream serving window")
    p.add_argument("--sessions", type=int, default=1,
                   help="concurrent streams on the card (MultiStream; aggregate fps)")
    p.add_argument("--in-flight", type=int, default=3,
                   help="pipelined protocol: outputs in flight")
    p.add_argument("--windows", type=int, default=3,
                   help="pipelined protocol: windows of --frames each; the best window "
                        "is the headline, every window's p50 beside it")
    p.add_argument("--uploaders", type=int, default=1,
                   help="pipelined protocol: upload threads")
    p.add_argument("--upload-batch", type=int, default=1,
                   help="frames a host-to-device copy (adds batch-1 frames of input lag)")
    p.add_argument("--kv-cache", choices=["bf16", "int8"], default="int8",
                   help="KV-cache storage: int8 (default) or bf16")
    p.add_argument("--spatial-qk", choices=["bf16", "int8"], default="bf16",
                   help="spatial self-attention QK precision: bf16 (default, the d-major "
                        "flash kernel) or int8 (the int8-QK flash kernel)")
    p.add_argument("--steps", type=int, nargs="*", default=[30, 40],
                   help="t_index_list (2 entries: the original's speed-table setting)")
    p.add_argument("--no-selftest", action="store_true",
                   help="skip the kernel selftest row")
    p.add_argument("--no-psnr-check", action="store_true",
                   help="skip the int8-cache against bf16-cache PSNR row")
    p.add_argument("--psnr-frames", type=int, default=15)
    p.add_argument("--budget", type=float, default=None,
                   help="wall-clock budget in seconds (default env LIVE2DIFF_BENCH_BUDGET_S "
                        "or 1450); an optional row whose estimated cost exceeds what "
                        "remains is skipped")
    p.add_argument("--no-second-res", action="store_true", help="skip the 768x512 row")
    p.add_argument("--no-burst", action="store_true", help="skip the stream_burst row")
    p.add_argument("--no-sessions-row", action="store_true",
                   help="skip the 4-session aggregate row")
    p.add_argument("--second-res-frames", type=int, default=40)
    # the port's own
    p.add_argument("--device", default="cuda",
                   help="cuda (default; exits non-zero without a card) or cpu")
    p.add_argument("--engine-dir", default="engines",
                   help="primed kernel libraries: <engine-dir>/aot/<key>/ (aot.py)")
    return p.parse_args(argv)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak_gib(device) -> str:
    import torch

    if device.type != "cuda":
        return "not measured on the CPU"
    return (f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB peak, "
            f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB now")


def build(args, height: int, width: int, kv_cache: str, spatial_qk: str, device,
          try_aot: bool = True):
    """bench.py's pipeline at the given settings (or the tiny one); with
    ``try_aot`` the kernel libraries are loaded from the engine directory
    where it is primed (``stream._aot_hit``, ``stream._aot_load_s``)."""
    import torch

    from .builder import build_pipeline
    from .tools._common import bench_config, build_bench_pipeline

    if args.tiny:
        built = build_pipeline(
            bench_config(args.steps) | {"noise_scheduler_kwargs": {}, "unet_additional_kwargs": {}},
            height=64, width=64, use_depth=False, dtype=torch.float32, device=device,
            unet_overrides=dict(block_out_channels=(8, 16, 16, 16), attention_head_dim=2,
                                cross_attention_dim=768, norm_num_groups=4,
                                motion_num_attention_heads=2))
    else:
        built = build_bench_pipeline(device, height, width, args.steps, kv_cache, spatial_qk,
                                     use_depth=not args.no_depth)
    built.stream._aot_hit = False
    built.stream._aot_load_s = 0.0
    if try_aot:
        from . import aot

        built.stream._aot_hit = aot.load_engines(built.stream, args.engine_dir)
        if built.stream._aot_hit:
            stage(f"aot kernel libraries loaded ({built.stream._aot_load_s:.1f}s)")
    return built


def free() -> None:
    """Collect and return the cached blocks, once the caller has released
    its pipeline's captured graphs (``release_graphs``: a graph's pool is
    not freed by dropping its state) and dropped its references (``del``)."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def prompt_for(built):
    from .builder import encode_prompt_for_pipeline

    return encode_prompt_for_pipeline(built, PROMPT)


def prepare_and_warm(stream, prompt, args, height: int, width: int, rng):
    """prepare on 8 frames, then the eager warm step and the capture of the
    uint8-frame step (its kernel launches on a stage line), then
    ``--warmup-iters`` replays. Returns (state, prepare seconds, warm step
    plus capture seconds)."""
    import torch

    warmup_frames = torch.from_numpy(rng.rand(8, height, width, 3).astype(np.float32) * 2 - 1)
    t0 = time.time()
    state, _ = stream.prepare(warmup_frames, prompt)
    _sync(stream.device)
    prepare_s = time.time() - t0
    stage(f"prepare done ({prepare_s:.1f}s)")
    from .ops import _build

    t0 = time.time()
    stream.warm_frame_step(torch.uint8)
    _build.reset_launch_counts()
    stream.capture_step(state, torch.uint8)  # the wrappers count one step here
    compile_s = time.time() - t0
    stage(LAUNCHES_TAG + json.dumps({k: v for k, v in _build.launch_counts.items() if v}))
    frame = torch.from_numpy((rng.rand(height, width, 3) * 255).astype(np.uint8))
    for _ in range(args.warmup_iters):
        state, out = stream(state, frame)
        _sync(stream.device)
    stage(f"frame step warm and captured ({compile_s:.1f}s)")
    return state, prepare_s, compile_s


def device_protocol(stream, state, args, height: int, width: int, rng, frames: int,
                    chain: int):
    """Chains of steps on uploaded frames, one synchronize a chain; then
    the upload and the fetch apart. Returns (stats, state)."""
    import torch

    dev = stream.device
    dev_frames = [torch.from_numpy((rng.rand(height, width, 3) * 255).astype(np.uint8)).to(dev)
                  for _ in range(16)]
    chain = max(chain, 1)
    n_chains = max(frames // chain, 1)
    chain_times = []
    for c in range(n_chains):
        t0 = time.perf_counter()
        for i in range(chain):
            state, out = stream(state, dev_frames[(c * chain + i) % 16])
        _sync(dev)
        chain_times.append((time.perf_counter() - t0) / chain)
    per = np.asarray(chain_times)
    # chains of equal length: the mean of their means is the frames' mean
    mean = float(per.mean()) * 1000
    stats = {
        "frame_ms_mean": round(mean, 2),
        "chain_mean_ms_p50": round(float(np.percentile(per, 50)) * 1000, 2),
        "chain_mean_ms_std": round(float(per.std()) * 1000, 2),
        "fps_mean": round(1000.0 / mean, 2),
        "fps_p50": round(1.0 / float(np.percentile(per, 50)), 2),
        "frames": n_chains * chain,
    }
    up, fetch = [], []
    frame = torch.from_numpy((rng.rand(height, width, 3) * 255).astype(np.uint8))
    for _ in range(5):
        t0 = time.perf_counter()
        f = frame.to(dev)
        _sync(dev)
        up.append(time.perf_counter() - t0)
        state, out = stream(state, f)
        _sync(dev)
        t0 = time.perf_counter()
        out.cpu()
        fetch.append(time.perf_counter() - t0)
    stats["upload_ms"] = round(float(np.median(up)) * 1000, 2)
    stats["fetch_ms"] = round(float(np.median(fetch)) * 1000, 2)
    stats["fps_mean_with_io"] = round(1000.0 / (mean + stats["upload_ms"] + stats["fetch_ms"]), 2)
    return stats, state


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0**2 / mse))


def _psnr_snr(outs_int8: np.ndarray, outs_bf16: np.ndarray):
    """(PSNR dB, SNR dB, output std) of the int8 outputs against the bf16
    ones: ``bench.py:421-427``."""
    val = psnr(outs_int8, outs_bf16)
    mse = np.mean((outs_int8.astype(np.float64) - outs_bf16.astype(np.float64)) ** 2)
    sig = float(np.var(outs_bf16.astype(np.float64)))
    snr = float("inf") if mse == 0 else 10 * np.log10(sig / mse)
    return round(val, 2), round(snr, 2), round(float(np.sqrt(sig)), 1)


def run_stream_outputs(stream, prompt, height: int, width: int, n_frames: int) -> np.ndarray:
    """prepare (seed 7) and ``n_frames`` uint8 outputs, frames from
    ``RandomState(1234)``: ``bench.py:310-322``."""
    import torch

    rng = np.random.RandomState(1234)
    warmup_frames = torch.from_numpy(rng.rand(8, height, width, 3).astype(np.float32) * 2 - 1)
    state, _ = stream.prepare(warmup_frames, prompt, seed=7)
    outs = []
    for _ in range(n_frames):
        frame = torch.from_numpy((rng.rand(height, width, 3) * 255).astype(np.uint8))
        state, out = stream(state, frame)
        outs.append(out.cpu().numpy())
    return np.stack(outs)


def sessions_row(built, args, height: int, width: int, s: int) -> dict:
    """``MultiStream`` of ``s`` sessions: synchronised chains of 10 rounds
    on uploaded frames, then ``PipelinedStream`` over 40 host rounds."""
    import torch

    from .stream.client import PipelinedStream
    from .stream.multi import MultiStream

    dev = built.stream.device
    prompt = prompt_for(built)
    rng = np.random.RandomState(0)
    ms = MultiStream(built.stream, s, prompt_len=prompt.shape[-2])
    try:
        warmup = torch.from_numpy(rng.rand(s, 8, height, width, 3).astype(np.float32) * 2 - 1)
        prompts = prompt.reshape(1, *prompt.shape[-2:]).expand(s, -1, -1)
        states, _ = ms.prepare(warmup, prompts)
        frames = torch.from_numpy((rng.rand(s, height, width, 3) * 255).astype(np.uint8))
        for _ in range(3):
            states, out = ms(states, frames)
            _sync(dev)
        dev_rounds = [torch.from_numpy((rng.rand(s, height, width, 3) * 255).astype(np.uint8))
                      .to(dev) for _ in range(10)]
        chain_times = []
        for _ in range(4):
            t0 = time.perf_counter()
            for r in dev_rounds:
                states, out = ms(states, r)
            _sync(dev)
            chain_times.append((time.perf_counter() - t0) / len(dev_rounds))
        dev_p50 = float(np.percentile(np.asarray(chain_times), 50)) * 1000
        dev_agg = s * 1000.0 / dev_p50
        stage(f"sessions={s} device-sync: round p50 {dev_p50:.1f}ms aggregate {dev_agg:.2f} fps")
        rounds = [(rng.rand(s, height, width, 3) * 255).astype(np.uint8) for _ in range(40)]
        ps = PipelinedStream(ms, states, max_in_flight=args.in_flight)
        t0 = time.perf_counter()
        n_out = sum(1 for _ in ps.map(rounds))
        wall = time.perf_counter() - t0
        per = np.asarray(ps.frame_times)
        p50 = float(np.percentile(per, 50)) * 1000 if per.size else 0.0
        agg = s * 1000.0 / p50 if p50 else 0.0
        stage(f"sessions={s}: p50 round {p50:.1f}ms aggregate {agg:.2f} fps "
              f"(wall {s * n_out / wall:.2f})")
        return {
            f"aggregate_fps_{s}sessions": round(agg, 2),
            f"aggregate_device_fps_{s}sessions": round(dev_agg, 2),
            f"round_ms_p50_{s}sessions_device": round(dev_p50, 2),
            f"wall_fps_{s}sessions": round(s * n_out / wall, 2),
        }
    finally:
        ms.release_graphs()


def burst_row(stream, state, args, height: int, width: int, rng):
    """``stream_burst`` of ``--chain`` frames: the first call, then
    ``max(frames // chain, 3)`` timed. Returns (keys, state)."""
    import torch

    bn = max(args.chain, 1)
    burst = torch.from_numpy((rng.rand(bn, height, width, 3) * 255).astype(np.uint8))
    state, _ = stream.stream_burst(state, burst)
    _sync(stream.device)
    dev_burst = burst.to(stream.device)
    bt = []
    for _ in range(max(args.frames // bn, 3)):
        t0 = time.perf_counter()
        state, _ = stream.stream_burst(state, dev_burst)
        _sync(stream.device)
        bt.append((time.perf_counter() - t0) / bn)
    bms = float(np.percentile(np.asarray(bt), 50)) * 1000
    stage(f"burst({bn}): {bms:.2f} ms/frame fps={1000.0 / bms:.2f}")
    return {f"fps_burst{bn}": round(1000.0 / bms, 2), f"burst{bn}_frame_ms_p50": round(bms, 2)}, \
        state


def serving_window(stream, state, args, height: int, width: int, rng):
    """``PipelinedStream.map`` over ``--frames`` host frames. Returns
    (keys, state)."""
    from .stream.client import PipelinedStream

    frames = [(rng.rand(height, width, 3) * 255).astype(np.uint8) for _ in range(args.frames)]
    ps = PipelinedStream(stream, state, max_in_flight=args.in_flight,
                         upload_threads=args.uploaders, upload_batch=args.upload_batch)
    t0 = time.perf_counter()
    n_out = sum(1 for _ in ps.map(frames))
    wall = time.perf_counter() - t0
    sper = np.asarray(ps.frame_times)
    sp50 = float(np.percentile(sper, 50)) * 1000 if sper.size else 0.0
    stage(f"serving window: wall {n_out / wall:.2f} fps, p50 {sp50:.1f}ms")
    return {"serving_wall_fps": round(n_out / wall, 2),
            "serving_p50_fps": round(1000.0 / sp50, 2) if sp50 else 0.0}, ps.state


def second_res_row(args, device, rng) -> dict:
    """The 768x512 row: its own pipeline (the libraries are loaded
    already), the device protocol over ``--second-res-frames`` and a burst
    of ``--chain`` frames, kept where it is within 3x of the row's p50.
    Its captured graphs are released on the way out."""
    height, width = 512, 768
    built = build(args, height, width, args.kv_cache, args.spatial_qk, device, try_aot=False)
    try:
        state, _, _ = prepare_and_warm(built.stream, prompt_for(built), args, height, width, rng)
        stats, state = device_protocol(built.stream, state, args, height, width, rng,
                                       args.second_res_frames, args.chain)
        row = {"fps_mean_768x512": stats["fps_mean"], "fps_p50_768x512": stats["fps_p50"],
               "vs_baseline_768x512": round(stats["fps_p50"] / _BASELINES[(768, 512)], 3)}
        burst, state = burst_row(built.stream, state, args, height, width, rng)
        key = f"fps_burst{max(args.chain, 1)}"  # bench.py:509 reads fps_burst10 always
        if 0 < burst[key] < 3 * stats["fps_p50"]:
            row["fps_burst_768x512"] = burst[key]
            row["vs_baseline_768x512_burst"] = round(burst[key] / _BASELINES[(768, 512)], 3)
        stage(f"768x512: p50 {row['fps_p50_768x512']} fps (x{row['vs_baseline_768x512']})")
        return row
    finally:
        built.stream.release_graphs()


def selftest_row() -> dict:
    from .tools.kernel_check import run_all

    st = run_all(quick=True)
    ok = st.pop("pass")
    worst = max((v["max_rel_err"] for v in st.values()), default=0.0)
    stage(f"kernel selftest: {'pass' if ok else 'fail'} (worst rel err {worst:.4f})")
    return {"kernel_selftest": "pass" if ok else "fail", "kernel_selftest_worst_rel_err": worst}


def _row(name: str, device, fn, on_error: dict) -> None:
    """Run one optional row into the result, its peak memory on a stage
    line; a failure records ``on_error`` and the bench goes on."""
    _reset_peak(device)
    try:
        _RESULT.update(fn())
    except Exception as e:  # the headline stands; the row says it failed
        stage(f"{name} row failed: {e!r}")
        _RESULT.update(on_error)
    stage(f"{name}: device memory {_peak_gib(device)}")
    emit()


def main(argv=None) -> int:
    global _BUDGET_S
    args = parse_args(argv)
    if args.budget is not None:
        _BUDGET_S = args.budget
    signal.signal(signal.SIGTERM, _on_term)
    stage("SIGTERM handler installed")

    import torch

    from .builder import resolve_device
    from .tools._common import card_line

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    if args.tiny and device.type == "cuda":
        print("bench: --tiny is the CPU smoke (bench.py's fp32 tiny UNet, whose head widths "
              "the card's kernels do not take); run it with --device cpu", file=sys.stderr)
        return 2
    result = _RESULT
    result["device"] = card_line(device)
    stage(f"device: {result['device']}")

    height, width = (64, 64) if args.tiny else (args.height, args.width)
    t_build = time.time()
    built = build(args, height, width, args.kv_cache, args.spatial_qk, device)
    stream = built.stream
    result["build_s"] = round(time.time() - t_build, 1)  # the AOT load included, as bench.py
    stage("pipeline built")
    prompt = prompt_for(built)
    rng = np.random.RandomState(0)
    baseline_fps = _BASELINES.get((width, height), BASELINE_FPS)

    # ---- the sessions-only invocation (--sessions N) ----------------------
    if args.sessions > 1:
        row = sessions_row(built, args, height, width, args.sessions)
        agg = row[f"aggregate_fps_{args.sessions}sessions"]
        print(json.dumps({
            "metric": f"aggregate_fps_p50_{width}x{height}_{len(args.steps)}steps_"
                      f"{args.sessions}sessions",
            "value": agg, "unit": "fps", "vs_baseline": round(agg / baseline_fps, 3),
            "protocol": "pipelined-rounds", "device": result["device"], **row,
        }))
        return 0

    _reset_peak(device)
    state, prepare_s, compile_s = prepare_and_warm(stream, prompt, args, height, width, rng)
    result["prepare_s"] = round(prepare_s, 1)
    result["first_step_compile_s"] = round(compile_s, 1)
    result["aot_hit"] = bool(stream._aot_hit)
    result["aot_load_s"] = round(stream._aot_load_s, 1)
    protocol = "sync" if args.sync else args.protocol

    if protocol == "device":
        stats, state = device_protocol(stream, state, args, height, width, rng, args.frames,
                                       args.chain)
        stage(f"device protocol: frame mean {stats['frame_ms_mean']}ms "
              f"(chain p50 {stats['chain_mean_ms_p50']}ms) fps={stats['fps_mean']}; "
              f"device memory {_peak_gib(device)}")
        result.update({
            "metric": f"fps_p50_{width}x{height}_{len(args.steps)}steps",
            "value": stats["fps_p50"],
            "unit": "fps",
            "vs_baseline": round(stats["fps_p50"] / baseline_fps, 3),
            "protocol": f"device-sync (chains of {max(args.chain, 1)}, p50)",
            **stats,
        })
        result.setdefault("skipped_rows", [])
        emit()  # the headline exists: printed now and after every row

        # cost estimates of the optional rows (s), from this run's own times
        frame_s = stats["frame_ms_mean"] / 1000
        row_s = result["build_s"] + prepare_s + compile_s
        est = {
            "aot_prime": 30,
            "burst": (max(args.frames // max(args.chain, 1), 3) + 1) * max(args.chain, 1)
            * frame_s * 2 + 10,
            "serving_window": args.frames * frame_s * 2 + 10,
            "sessions": row_s + 60 * SESSIONS * frame_s + 30,
            "psnr_int8_side": prepare_s + args.psnr_frames * frame_s * 2 + 10,
            "second_res": 1.5 * row_s + 3 * args.second_res_frames * frame_s + 30,
            "psnr_bf16_side": row_s + args.psnr_frames * frame_s * 2 + 20,
            "selftest": 60,
        }
        if (not args.tiny and not stream._aot_hit and device.type == "cuda"
                and phase_ok("aot_prime", est["aot_prime"])):
            from . import aot

            t0 = time.time()
            key = aot.save_engines(stream, args.engine_dir)
            stage(f"aot kernel libraries saved to {args.engine_dir} (key {key}, "
                  f"{time.time() - t0:.1f}s)")

        if not args.no_burst and phase_ok("burst", est["burst"]):
            def burst():
                nonlocal state
                keys, state = burst_row(stream, state, args, height, width, rng)
                return keys

            _row("burst", device, burst, {f"fps_burst{max(args.chain, 1)}": None})

        if (not args.no_serving_window and not args.tiny
                and phase_ok("serving_window", est["serving_window"])):
            def serving():
                nonlocal state
                keys, state = serving_window(stream, state, args, height, width, rng)
                return keys

            _row("serving_window", device, serving, {"serving_wall_fps": None})
        del state
        stream.release_graphs()
        free()

        # priority when the budget is short: sessions > 768x512 > psnr > selftest
        if (not args.tiny and not args.no_sessions_row
                and phase_ok("sessions", est["sessions"])):
            _row("sessions", device, lambda: sessions_row(built, args, height, width, SESSIONS),
                 {f"aggregate_fps_{SESSIONS}sessions": None})
            free()

        wants_psnr = (not args.tiny and not args.no_psnr_check
                      and (args.kv_cache == "int8" or args.spatial_qk == "int8"))
        outs_int8: Optional[np.ndarray] = None
        if wants_psnr and phase_ok("psnr_int8_side", est["psnr_int8_side"]):
            try:
                outs_int8 = run_stream_outputs(stream, prompt, height, width, args.psnr_frames)
            except Exception as e:
                stage(f"psnr int8 side failed: {e!r}")
                result["psnr_int8_vs_bf16"] = None
        stream.release_graphs()
        del stream, built
        free()

        if (not args.tiny and not args.no_second_res and (width, height) != (768, 512)
                and phase_ok("second_res", est["second_res"])):
            _row("768x512", device, lambda: second_res_row(args, device, rng),
                 {"fps_mean_768x512": None})
            free()

        if outs_int8 is not None and phase_ok("psnr_bf16_side", est["psnr_bf16_side"]):
            def psnr_row():
                side = build(args, height, width, "bf16", "bf16", device, try_aot=False)
                try:
                    outs_bf16 = run_stream_outputs(side.stream, prompt_for(side), height, width,
                                                   args.psnr_frames)
                finally:
                    side.stream.release_graphs()
                p, s, std = _psnr_snr(outs_int8, outs_bf16)
                stage(f"psnr int8 defaults vs bf16: {p} dB (snr {s} dB)")
                return {"psnr_int8_vs_bf16": p, "snr_int8_vs_bf16": s,
                        "output_std_int8_check": std, "psnr_frames": args.psnr_frames}

            _row("psnr", device, psnr_row, {"psnr_int8_vs_bf16": None})
            free()

        if (not args.tiny and not args.no_selftest and device.type == "cuda"
                and phase_ok("selftest", est["selftest"])):
            _row("selftest", device, selftest_row, {"kernel_selftest": "error"})
        stage(f"prepare={prepare_s:.1f}s compile={compile_s:.1f}s headline mean "
              f"{result['frame_ms_mean']}ms fps={result['value']}")
        emit()
        return 0

    if protocol == "sync":
        times = []
        for _ in range(args.frames):
            frame = torch.from_numpy((rng.rand(height, width, 3) * 255).astype(np.uint8))
            t0 = time.perf_counter()
            state, out = stream(state, frame)
            _sync(device)
            times.append(time.perf_counter() - t0)
        fps = 1.0 / float(np.mean(times))
        print(json.dumps({
            "metric": f"sync_fps_{width}x{height}_{len(args.steps)}steps",
            "value": round(fps, 2), "unit": "fps", "vs_baseline": round(fps / baseline_fps, 3),
            "protocol": "sync (one synchronised step a frame)", "device": result["device"],
        }))
        return 0

    # pipelined: PipelinedStream windows, the best window's p50 the headline
    from .stream.client import PipelinedStream

    frames = [(rng.rand(height, width, 3) * 255).astype(np.uint8) for _ in range(args.frames)]
    window_stats = []
    for w in range(max(args.windows, 1)):
        ps = PipelinedStream(stream, state, max_in_flight=args.in_flight,
                             upload_threads=args.uploaders, upload_batch=args.upload_batch)
        t0 = time.perf_counter()
        n_out = sum(1 for _ in ps.map(frames))
        wall = time.perf_counter() - t0
        state = ps.state
        per = np.asarray(ps.frame_times)
        wp50 = float(np.percentile(per, 50)) * 1000 if per.size else 0.0
        window_stats.append((wp50, n_out / wall, n_out))
        stage(f"window {w}: p50 {wp50:.1f}ms, wall {n_out / wall:.2f} fps")
    p50, throughput, n_out = min(window_stats)
    fps = 1000.0 / p50 if p50 else 0.0
    print(json.dumps({
        "metric": f"serving_fps_p50_{width}x{height}_{len(args.steps)}steps",
        "value": round(fps, 2), "unit": "fps", "vs_baseline": round(fps / baseline_fps, 3),
        "protocol": f"pipelined serving (best of {len(window_stats)} windows)",
        "wall_throughput_fps": round(throughput, 2),
        "all_windows_p50_ms": [round(w[0], 1) for w in window_stats],
        "frames": n_out, "device": result["device"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
