#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (live2diff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the time to build the port's CUDA kernels with nvcc.
2. kernels: each hand-written kernel against its plain torch version on the
   card, at every shape the 512x512 stream step gives it, with its time,
   the plain version's time, one library call's time as a yardstick
   (never used by the port), and its roofline bound.
3. small input: a narrow pipeline (64x64 frames) on the card, bf16 with
   the kernels, against the same weights and noise in fp32 on the CPU.
4. slice: ``build_pipeline`` at full SD-1.5 width (bench config: 2 LCM
   steps, TAESD, int8 KV cache, uint8 frames), random weights from seed 0:
   ``prepare`` on 8 warmup frames, then streamed frames, timed; every
   kernel's launches per stream step are asserted.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or run from a
directory that does not hold the port, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

MEM_BW = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK = {"bf16": 989e12, "fp32": 67e12}  # dense tensor-core bf16; fp32 outside tensor cores

# plain references: full fp32 (cuDNN would otherwise run fp32 convs in TF32)
TF32_OFF = "torch.backends.cudnn.allow_tf32 = False; torch.backends.cuda.matmul.allow_tf32 = False"

BENCH_CONFIG = {  # bench.py's make_config([30, 40])
    "num_inference_steps": 50,
    "t_index_list": [30, 40],
    "noise_scheduler_kwargs": {
        "num_train_timesteps": 1000, "beta_start": 0.00085,
        "beta_end": 0.012, "beta_schedule": "linear",
    },
    "unet_additional_kwargs": {
        "cond_mapping": True,
        "motion_module_kwargs": {
            "num_attention_heads": 8,
            "temporal_position_encoding_max_len": 24,
            "attention_kwargs": {"window_size": 16, "sink_size": 8},
        },
    },
}
STREAM_FRAMES = 32
EXPECTED_PER_STEP = {"stream_attention_int8": 40, "flash_attention": 32,
                     "conv3x3": 64, "conv3x3_s2": 3}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


_L2_FLUSH = []  # a buffer larger than the 50 MB L2, made at first use


def time_ms(fn, reps: int) -> float:
    """Mean device ms per call over ``reps`` calls after one warm-up call.
    The L2 cache is overwritten before each call (outside its events): in
    the stream step every kernel finds its inputs cold."""
    import torch

    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(128 << 20, dtype=torch.uint8, device="cuda"))
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        _L2_FLUSH[0].fill_(1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def bound(nbytes: float, flops: float, peak: str):
    t_bytes, t_ops = nbytes / MEM_BW * 1e3, flops / PEAK[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(kernel_out, plain_out, tol: float):
    """Max abs error and max abs error relative to max |plain|; raises above tol."""
    diff = (kernel_out.float() - plain_out.float()).abs().max().item()
    scale = plain_out.float().abs().max().item()
    rel = diff / max(scale, 1e-30)
    if not rel <= tol:  # also catches NaN
        raise AssertionError(f"kernel disagrees with its plain version: rel {rel:.3e} > {tol}")
    return diff, rel


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version at production shapes
# ---------------------------------------------------------------------------


def check_stream_attention(torch, gen, dev):
    from live2diff_tpu_torch.ops.stream_attention import (
        stream_window_attention_int8, stream_window_attention_plain,
    )

    s, heads, window = 2, 8, 16
    rows = []
    # (C, HW) of the 4 UNet levels at 512x512; 10 calls each per stream step
    for c, hw in ((320, 4096), (640, 1024), (1280, 256), (1280, 64)):
        q = torch.randn(s, hw, c, generator=gen, device=dev).to(torch.bfloat16)
        data = torch.randint(-127, 128, (s, 2, window, c, hw), generator=gen, device=dev,
                             dtype=torch.int8)
        scales = 0.002 + 0.02 * torch.rand(s, 2, window, c, generator=gen, device=dev)
        extra = torch.randn(s, window, heads, hw, generator=gen, device=dev)
        extra[:, 9:] = float("-inf")  # an early-stream mask: slots 9..15 not visible
        pe_v = torch.randn(s, window, c, generator=gen, device=dev)
        args = (q, data, scales, extra, pe_v, (c // heads) ** -0.5, heads)
        out = stream_window_attention_int8(*args)
        torch.cuda.synchronize()
        ref = stream_window_attention_plain(*args)
        torch.cuda.synchronize()
        # the plain version rounds the dequantised K/V and the probabilities
        # to bf16 (~2^-9 each); the kernel keeps them in fp32
        err, rel = compare(out, ref, 2e-2)
        nbytes = (2 * q.numel() + data.numel() + 4 * scales.numel() + 4 * extra.numel()
                  + 4 * pe_v.numel() + 2 * q.numel())
        flops = 6 * window * s * c * hw  # q.k, v dequant + pe, p.v
        b_ms, b_by = bound(nbytes, flops, "fp32")
        rows.append(dict(
            shape=f"q[{s},{hw},{c}] cache[{s},2,{window},{c},{hw}] int8", calls=10, prepare_calls=0,
            max_abs_err=err, rel_err=rel, tol=2e-2,
            ms=time_ms(lambda: stream_window_attention_int8(*args), 50),
            plain_ms=time_ms(lambda: stream_window_attention_plain(*args), 3),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ))
    return rows


def check_flash(torch, gen, dev):
    import torch.nn.functional as F

    from live2diff_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    h = 8
    rows = []
    # (B, Sq, Sk, D, calls per stream step, calls in prepare). The stream
    # step: self- and cross-attention (77 text tokens) of the 2-step batch
    # at the 4 levels. prepare(): spatial attention over the 8 warmup frames
    # (B = 8), and the bidirectional motion attention over those 8 frames
    # with the positions folded into the batch (B = HW, S = 8).
    for b, sq, sk, d, calls, prep in (
        (2, 4096, 4096, 40, 5, 0), (2, 1024, 1024, 80, 5, 0), (2, 256, 256, 160, 5, 0),
        (2, 64, 64, 160, 1, 0), (2, 4096, 77, 40, 5, 0), (2, 1024, 77, 80, 5, 0),
        (2, 256, 77, 160, 5, 0), (2, 64, 77, 160, 1, 0),
        (8, 4096, 4096, 40, 0, 10), (4096, 8, 8, 40, 0, 20), (1024, 8, 8, 80, 0, 20),
        (256, 8, 8, 160, 0, 20), (64, 8, 8, 160, 0, 20),
    ):
        q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(b, sk, h, d, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(b, sk, h, d, generator=gen, device=dev).to(torch.bfloat16)
        scale = d ** -0.5
        out = flash_attention(q, k, v, scale)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        # p is rounded to bf16 against a running max in the kernel and against
        # the final max in the plain version; the output is rounded to bf16
        err, rel = compare(out, ref, 2e-2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        b_ms, b_by = bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                           4 * b * h * sq * sk * d, "bf16")
        rows.append(dict(
            shape=f"q[{b},{sq},{h},{d}] k[{b},{sk},{h},{d}]", calls=calls, prepare_calls=prep,
            max_abs_err=err, rel_err=rel, tol=2e-2,
            ms=time_ms(lambda: flash_attention(q, k, v, scale), 20),
            plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, scale), 2),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20),
        ))
    return rows


def check_conv(torch, gen, dev, stride: int):
    import torch.nn.functional as F

    from live2diff_tpu_torch.ops.conv import conv3x3, conv3x3_plain

    # (B, H = W, Cin, bias, skip+ReLU, calls per stream step, calls in
    # prepare): the stream step codes one frame (B = 1); prepare() encodes
    # and decodes the 8 warmup frames as one batch (B = 8, largest level shown)
    if stride == 1:
        shapes = ((1, 512, 3, True, False, 1, 0), (1, 512, 64, True, True, 7, 0),
                  (1, 256, 64, True, True, 19, 0), (1, 128, 64, True, True, 19, 0),
                  (1, 64, 64, True, True, 18, 0), (8, 512, 64, True, True, 0, 7))
    else:  # the three encoder downsamples: no bias, no ReLU
        shapes = ((1, 512, 64, False, False, 1, 0), (1, 256, 64, False, False, 1, 0),
                  (1, 128, 64, False, False, 1, 0), (8, 512, 64, False, False, 0, 1))
    rows = []
    for nb, hw, cin, has_bias, fused, calls, prep in shapes:
        x = torch.randn(nb, hw, hw, cin, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(64, cin, 3, 3, generator=gen, device=dev) / (9 * cin) ** 0.5
             ).to(torch.bfloat16)
        bias = torch.randn(64, generator=gen, device=dev).to(torch.bfloat16) if has_bias else None
        ho = hw // stride
        skip = (torch.randn(nb, ho, ho, 64, generator=gen, device=dev).to(torch.bfloat16)
                if fused else None)
        args = (x, w, bias, skip, fused, stride)
        out = conv3x3(*args)
        torch.cuda.synchronize()
        ref = conv3x3_plain(*args)
        torch.cuda.synchronize()
        # same bf16 operands and fp32 sums in another order; bf16 output rounding
        err, rel = compare(out, ref, 1e-2)
        out_elems = nb * ho * ho * 64
        nbytes = 2 * (x.numel() + w.numel() + 64 * has_bias + out_elems * (1 + fused))
        b_ms, b_by = bound(nbytes, 2 * out_elems * 9 * cin, "bf16")
        x_cl = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels-last for cuDNN
        rows.append(dict(
            shape=f"x[{nb},{hw},{hw},{cin}] stride {stride}" + (" +skip+relu" if fused else ""),
            calls=calls, prepare_calls=prep, max_abs_err=err, rel_err=rel, tol=1e-2,
            ms=time_ms(lambda: conv3x3(*args), 50),
            plain_ms=time_ms(lambda: conv3x3_plain(*args), 5),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.conv2d(x_cl, w, bias, stride, 1), 50),
        ))
    return rows


def summarise(name, source, replaces, rows):
    """One kernels-line entry: per-step totals (sum over shapes of calls x
    per-call time) and the per-shape rows."""
    def total(key):
        vals = [r[key] for r in rows]
        return None if any(v is None for v in vals) else sum(r["calls"] * r[key] for r in rows)

    by_bytes = sum(r["calls"] * r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
    by_ops = sum(r["calls"] * r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    return dict(
        name=name, route="cuda", source=source, replaces=replaces, launches=None,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
        bound_by="bytes" if by_bytes >= by_ops else "operations",
        library_ms=total("library_ms"), per="stream step (sum over shapes of calls x ms)",
        shapes=rows,
    )


# ---------------------------------------------------------------------------
# phase 3: small input, card against CPU fp32
# ---------------------------------------------------------------------------

SMALL_UNET = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=2,
                  cross_attention_dim=64, norm_num_groups=8, motion_num_attention_heads=2)
SMALL_CONFIG = {
    "num_inference_steps": 50, "t_index_list": [30, 40],
    "unet_additional_kwargs": {"motion_module_kwargs": {
        "num_attention_heads": 2, "attention_kwargs": {"window_size": 16, "sink_size": 8},
    }},
}
# relative RMS error per frame. bf16 against fp32 (both plain torch, on the
# CPU) measured 0.023-0.034 at this size; 0.10 is three times that, and a
# wrong kernel gives errors of order 1.
SMALL_TOL = 0.10


def fan_in_init_(module, gen) -> None:
    """O(1) activations for a meaningful comparison: kernels N(0, 1/fan_in),
    norm weights N(1, 0.1), biases N(0, 0.05)."""
    import torch

    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() > 1:
                p.normal_(0.0, 1.0 / p[0].numel() ** 0.5, generator=gen)
            elif name.endswith("weight"):
                p.normal_(1.0, 0.1, generator=gen)
            else:
                p.normal_(0.0, 0.05, generator=gen)


def small_input_check(torch):
    from live2diff_tpu_torch.builder import build_pipeline

    def build(device, dtype):
        return build_pipeline(SMALL_CONFIG, 64, 64, dtype=dtype, kv_cache_dtype="int8",
                              seed=0, device=device, unet_overrides=SMALL_UNET)

    ref, card = build("cpu", torch.float32), build("cuda", torch.bfloat16)
    gen = torch.Generator().manual_seed(5)
    fan_in_init_(ref.unet, gen)
    fan_in_init_(ref.vae, gen)
    card.unet.load_state_dict(ref.unet.state_dict())
    card.vae.load_state_dict(ref.vae.state_dict())

    def noise(seed):
        g = torch.Generator().manual_seed(seed)
        return lambda shape: torch.randn(shape, generator=g)

    g = torch.Generator().manual_seed(1)
    warm = torch.rand(8, 64, 64, 3, generator=g) * 2 - 1
    prompt = torch.randn(1, 77, 64, generator=g)
    frames = [(torch.rand(64, 64, 3, generator=g) * 255).to(torch.uint8) for _ in range(12)]

    def rel_rms(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        return (((a - b) ** 2).mean().sqrt() / (b ** 2).mean().sqrt()).item()

    s_ref, w_ref = ref.stream.prepare(warm, prompt, noise=noise(10))
    s_card, w_card = card.stream.prepare(warm, prompt, noise=noise(10))
    errs = [rel_rms(w_card, w_ref)]
    for i, f in enumerate(frames):
        s_ref, o_ref = ref.stream(s_ref, f, noise=noise(100 + i))
        s_card, o_card = card.stream(s_card, f, noise=noise(100 + i))
        if not torch.isfinite(o_card).all():
            raise AssertionError(f"small input: frame {i} not finite")
        errs.append(rel_rms(o_card, o_ref))
    torch.cuda.synchronize()
    if not max(errs) <= SMALL_TOL:
        raise AssertionError(f"small input: rel RMS errors {errs} exceed {SMALL_TOL}")
    return errs


# ---------------------------------------------------------------------------
# phase 4: the slice at full width
# ---------------------------------------------------------------------------


def run_slice(torch, _build):
    from live2diff_tpu_torch.builder import build_pipeline

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    built = build_pipeline(BENCH_CONFIG, 512, 512, dtype=torch.bfloat16, kv_cache_dtype="int8",
                           output_uint8=True, seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    stream = built.stream
    n_params = sum(p.numel() for p in built.unet.parameters())

    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.randn(1, 77, 768, generator=gen, device=dev)
    warm = torch.rand(8, 512, 512, 3, generator=gen, device=dev) * 2 - 1
    frames = torch.randint(0, 256, (STREAM_FRAMES, 512, 512, 3), generator=gen, device=dev,
                           dtype=torch.uint8)

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state, warm_out = stream.prepare(warm, prompt, seed=2)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    warm_counts = dict(_build.launch_counts)
    if warm_out.shape != (8, 512, 512, 3) or warm_out.dtype != torch.uint8:
        raise AssertionError(f"warmup output {tuple(warm_out.shape)} {warm_out.dtype}")
    if len(state.kv_caches) != 40 or not all(torch.isfinite(s).all() for _, s in state.kv_caches):
        raise AssertionError("prepare() left missing or non-finite KV-cache scales")
    first_step_s = stream.warm_frame_step(torch.uint8)

    _build.reset_launch_counts()
    times, outs = [], []
    for i in range(STREAM_FRAMES):
        t0 = time.perf_counter()
        state, out = stream(state, frames[i])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
        # uint8 frames cannot show a NaN: check the latents the step made
        if not torch.isfinite(state.x_t_buffer).all():
            raise AssertionError(f"frame {i}: non-finite latents")
    counts = dict(_build.launch_counts)
    for out in outs:
        if out.shape != (512, 512, 3) or out.dtype != torch.uint8:
            raise AssertionError(f"frame output {tuple(out.shape)} {out.dtype}")
    for name, per_step in EXPECTED_PER_STEP.items():
        if counts[name] != per_step * STREAM_FRAMES:
            raise AssertionError(
                f"{name}: {counts[name]} launches over {STREAM_FRAMES} frames, "
                f"expected {per_step} per step"
            )
    for name in ("flash_attention", "conv3x3", "conv3x3_s2"):  # warmup has no stream attention
        if warm_counts[name] == 0:
            raise AssertionError(f"{name}: no launch in prepare()")
    steady = sorted(times[2:])
    profile = profile_steps(torch, stream, state, frames[:4])
    if isinstance(profile["device_ms_per_step"], float):
        # the profiler slows the host; the busy share of an unprofiled step
        profile["device_ms_over_frame_ms_p50"] = (
            profile["device_ms_per_step"] / statistics.median(steady))
    return dict(
        unet_params=n_params, build_s=build_s, prepare_s=prepare_s,
        first_step_s=first_step_s, frames=STREAM_FRAMES,
        frame_ms_p50=statistics.median(steady),
        frame_ms_p90=steady[int(0.9 * (len(steady) - 1))],
        frame_ms_all=times,
        fps_p50=1e3 / statistics.median(steady),
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        outputs_uint8_512x512x3=True,
        output_mean=float(torch.stack(outs).float().mean()),
        output_std=float(torch.stack(outs).float().std()),
        launches_warmup=warm_counts,
        launches_stream=counts,
        launches_per_step={k: v / STREAM_FRAMES for k, v in counts.items()},
        profile=profile,
    ), counts


def profile_steps(torch, stream, state, frames):
    """torch.profiler over a few stream steps: device time per step by
    kernel name, and the device-busy share of the wall time (which the
    profiler's own host overhead lowers)."""
    from torch.profiler import ProfilerActivity, profile

    n = len(frames)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for frame in frames:
            state, _ = stream(state, frame)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for e in prof.key_averages():  # device-side events only: the kernels
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / n, e.count / n, e.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    return dict(
        steps=n, wall_ms_per_step=wall_ms,
        device_ms_per_step=device_ms if rows else "not measured",
        device_busy_share=device_ms / wall_ms if rows else "not measured",
        top=[dict(ms_per_step=r[0], calls_per_step=r[1], name=r[2][:90]) for r in rows[:25]],
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 2
    try:
        from live2diff_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port (live2diff_tpu_torch) is not importable: {e}",
              file=sys.stderr)
        return 2

    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build(["stream_attention", "flash_attention", "conv3x3"])
    print(f"kernel build (3 nvcc in parallel): {time.perf_counter() - t0:.1f} s", flush=True)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"plain references: {TF32_OFF}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)

    phase("kernels against their plain versions")
    kernels = [
        summarise("stream_attention_int8", "live2diff_tpu_torch/csrc/stream_attention.cu",
                  "live2diff_tpu/ops/stream_attention.py:198", check_stream_attention(torch, gen, dev)),
        summarise("flash_attention", "live2diff_tpu_torch/csrc/flash_attention.cu",
                  "live2diff_tpu/ops/flash_attention.py:143", check_flash(torch, gen, dev)),
        summarise("conv3x3", "live2diff_tpu_torch/csrc/conv3x3.cu",
                  "live2diff_tpu/ops/conv.py:492", check_conv(torch, gen, dev, 1)),
        summarise("conv3x3_s2", "live2diff_tpu_torch/csrc/conv3x3.cu",
                  "live2diff_tpu/ops/conv.py:507", check_conv(torch, gen, dev, 2)),
    ]
    for k in kernels:
        for r in k["shapes"]:
            print(f"{k['name']:22s} {r['shape']:48s} rel {r['rel_err']:.2e} (tol {r['tol']}) "
                  f"ms {r['ms']:.4f} plain {r['plain_ms']:.3f} bound {r['bound_ms']:.4f} "
                  f"({r['bound_by']}) library {r['library_ms']}")
    sys.stdout.flush()

    phase("small input: card (bf16, kernels) against CPU (fp32, plain)")
    errs = small_input_check(torch)
    print(f"per-frame relative RMS error, warmup then 12 frames: {errs}")

    phase("slice at full width: 512x512, SD-1.5 motion UNet, TAESD, int8 cache")
    result, counts = run_slice(torch, _build)
    print(json.dumps({k: v for k, v in result.items() if k != "frame_ms_all"}))
    print(f"frame ms all: {[round(t, 3) for t in result['frame_ms_all']]}")
    for k in kernels:
        k["launches"] = counts[k["name"]]
        k["launches_per_step"] = counts[k["name"]] / STREAM_FRAMES

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
