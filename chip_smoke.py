#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (live2diff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, the max SM clock (it sets the exponential rate of the flash
   bounds), and the time to build the port's CUDA kernels with nvcc.
2. kernels: each hand-written kernel against its plain torch version on the
   card, at every shape the 512x512 and 768x512 stream steps and
   ``prepare`` give it, with its time, the plain version's time, one
   library call's time as a yardstick (never used by the port), and its
   roofline bound (for the flash kernels the larger of the bytes, the
   tensor-core operations and the exponentials at 16 a clock per SM); the
   stream-attention rows also print their route and their share of the
   bound. The GroupNorm kernel is checked after phase 7, and the LayerNorm
   kernel again after phase 10, at the shapes those phases recorded. The
   int8-QK entry's pre-pass is held to ``quantize_groups`` bit for bit and
   timed alone at each of its shapes. An empty kernel, timed the same way,
   gives the launch floor under the short calls. Then the int8 KV cache's
   quantisation on the card against the CPU, bit for bit.
3. small input: a narrow pipeline (64x64 frames, a narrow 384x384 DPT) on
   the card, bf16 with the kernels, against the same weights and noise in
   fp32 on the CPU.
4. slice: bench.py's main path. ``build_pipeline`` at full width (SD-1.5
   motion UNet, 2 LCM steps, TAESD, DPT-hybrid depth, int8 KV cache, uint8
   frames), random weights from seed 0: ``prepare`` on 8 warmup frames,
   then streamed frames, timed and profiled; every kernel's launches in
   ``prepare`` and per stream step are asserted (stream attention's by
   route too: on a 132-SM card 40 on TMA, 30 of them in clusters), and the
   profiled launches a step may not exceed 7,265. Prints the host time the
   flash kernels, the conv and stream attention spend encoding TMA tensor
   maps, per call.
5. bf16 cache: the same at full width with a bf16 KV cache and no depth
   model (``--kv-cache bf16 --no-depth``): ``prepare`` and 8 frames, with
   the bf16 stream-attention kernel's launches asserted.
6. int8 QK: phase 4 with ``flash_variant="int8"`` (bench.py's
   ``--spatial-qk int8``): 32 frames, profiled; the int8-QK flash kernel
   takes the 10 self-attentions a step that pass the flash gate.
7. GroupNorm kernel: phase 4 with ``gn_kernel_sites="all"``: 16 frames,
   profiled, beside phase 4's frame times and device profile; every
   GroupNorm module whose input meets the JAX conditions launches the
   kernel once (counted by hooks on the modules over ``prepare`` and one
   step), and the profile holds exactly one device kernel of
   ``group_norm.cu`` for each such call (one launch a call; a trace that
   dropped a record is taken again, up to twice; the phase's profiled
   launches a step are printed); every step call takes the
   resident route (x read once). Then the kernel is checked at each shape
   it saw, with its events and device time and its share of the bound.
   The pipelines of phases 4, 6 and 7 then stream 30 more frames each in
   turn, so that their frame times can be compared under the same host
   conditions.
8. 768x512: bench.py's second row (``--width 768 --height 512``, d-major
   flash, as bench.py runs it): 24 frames, profiled.
9. s-major A/B: phase 8 with ``flash_variant="smajor"``: 8 frames,
   profiled; the s-major flash kernel takes the 10 gated self-attentions a
   step, at S = 6144 and 1536.
10. LayerNorm kernel at every site (``ln_kernel_sites="all"``, the UNet's
   C = 320-1280 LayerNorms with it): ``prepare`` and 4 frames at 512x512;
   every LayerNorm whose input meets the JAX conditions launches the kernel
   once (counted by hooks, which log its shapes); then the kernel is
   checked against its plain version at each of those shapes.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or run from a
directory that does not hold the port, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from collections import Counter, defaultdict

MEM_BW = 3.35e12  # H100 SXM HBM3, bytes/s
# dense tensor-core bf16 and int8; fp32 outside tensor cores
PEAK = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
# exponentials: 16 a clock per SM (compute capability 9.0), times the SMs
# and the card's max SM clock, both read in main()
SFU_PER_SM_CLOCK = 16
SFU_RATE = []  # [exp / s], set once the card is known
# kernel launches a main-path stream step in the profile, measured before
# the int8 KV cache divided by a tensor: that division must not add any
MAIN_PATH_LAUNCHES_PER_STEP = 7265
# stream-attention launches a main-path step by route (132 SMs)
MAIN_PATH_ROUTES = {"tma": 40, "scalar": 0, "cluster": 30}

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
BF16_FRAMES = 8
INT8_QK_FRAMES = 32
GN_FRAMES = 16
WIDE_FRAMES = 24
SMAJOR_FRAMES = 8
LN_FRAMES = 4
INTERLEAVED_ROUNDS = 30
# the three opt-in kernels: none of them on bench.py's main path
OPT_IN_OFF = {"flash_attention_smajor": 0, "flash_attention_int8": 0, "group_norm": 0}
# launches per stream step with depth: flash 32 in the UNet + 12 in the ViT;
# the one batched encode of frame and depth image keeps the conv counts
EXPECTED_PER_STEP = {"stream_attention_int8": 40, "flash_attention": 44,
                     "conv3x3": 64, "conv3x3_s2": 3, "layer_norm": 24,
                     "stream_attention_bf16": 0, **OPT_IN_OFF}
# prepare(): 2 warmup UNet forwards (32 spatial + 40 motion attentions each)
# and one DPT forward over the 8 warmup frames
EXPECTED_PREPARE = {"stream_attention_int8": 0, "flash_attention": 156,
                    "conv3x3": 64, "conv3x3_s2": 3, "layer_norm": 24,
                    "stream_attention_bf16": 0, **OPT_IN_OFF}
EXPECTED_PER_STEP_BF16 = {"stream_attention_bf16": 40, "stream_attention_int8": 0,
                          "flash_attention": 32, "conv3x3": 64, "conv3x3_s2": 3,
                          "layer_norm": 0, **OPT_IN_OFF}
# a flash variant takes the self-attentions that pass the flash gate
# (S >= 1024, a multiple of 128): the 5 spatial transformers at each of the
# two top latent levels, 10 a step and 10 per warmup forward in prepare;
# every other attention keeps the d-major kernel
GATED_PER_STEP, GATED_PREPARE = 10, 20


def with_variant(expected, name, gated):
    """``expected`` with ``gated`` d-major flash launches moved to ``name``."""
    return {**expected, "flash_attention": expected["flash_attention"] - gated, name: gated}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


_L2_FLUSH = []  # a buffer ten times the 50 MB L2, made at first use


def time_ms(fn, reps: int) -> float:
    """Mean device ms per call over ``reps`` calls after one warm-up call.
    The L2 cache is overwritten before each call (outside its events): in
    the stream step every kernel finds its inputs cold. Overwriting 512 MB
    keeps the card busy for ~0.2 ms, longer than the host takes to launch a
    call, so the call is queued before its start event runs and the host's
    time does not count."""
    import torch

    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(512 << 20, dtype=torch.uint8, device="cuda"))
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


def device_ms(fn, reps: int, kernel: str, tries: int = 3):
    """Mean device ms of the kernel named ``kernel`` (a part of its name)
    that ``fn`` launches once a call, over its records in a torch.profiler
    trace of ``reps`` calls, each after the same L2 overwrite as
    ``time_ms``: the kernel's own time, without the launch that events
    around a call count. Late in a long run the profiler drops a few
    records of a trace (3-4 of 50 in this script's phase 7 on an H100); a
    dropped record is absent, the others keep their durations, so the mean
    is taken over the records kept. A trace that kept fewer than 80 % of
    them is taken again, up to ``tries`` times, then "not measured" with the
    counts seen."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(512 << 20, dtype=torch.uint8, device="cuda"))
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                _L2_FLUSH[0].fill_(1)
                fn()
            torch.cuda.synchronize()
        us, count = 0.0, 0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA or kernel not in e.key:
                continue
            t = getattr(e, "self_device_time_total", None)
            us += e.self_cuda_time_total if t is None else t
            count += e.count
        if reps * 0.8 <= count <= reps:
            return us / 1e3 / count
        seen.append(count)
    return f"not measured ({kernel} records {seen} in traces of {reps} calls)"


def bound(nbytes: float, *ops, exps: float = 0):
    """The larger of the bytes' time at MEM_BW and the operations' time,
    ``ops`` being (count, peak name) pairs, each at its own peak (summed:
    they share the tensor cores or the fp32 lanes). ``exps`` exponentials
    run on the SFUs at the same time as the tensor cores, so the operations'
    time is the larger of the two."""
    t_bytes = nbytes / MEM_BW * 1e3
    t_ops = sum(n / PEAK[peak] * 1e3 for n, peak in ops)
    if exps:
        t_ops = max(t_ops, exps / SFU_RATE[0] * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(kernel_out, plain_out, tol: float):
    """Max abs error and max abs error relative to max |plain|; raises above tol."""
    diff = (kernel_out.float() - plain_out.float()).abs().max().item()
    scale = plain_out.float().abs().max().item()
    rel = diff / max(scale, 1e-30)
    if not rel <= tol:  # also catches NaN
        raise AssertionError(f"kernel disagrees with its plain version: rel {rel:.3e} > {tol}")
    return diff, rel


def rel_rms(out, ref) -> float:
    """||out - ref|| / ||ref|| over all elements, in fp32."""
    d = out.float() - ref.float()
    return (d.pow(2).mean().sqrt() / ref.float().pow(2).mean().sqrt()).item()


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version at production shapes
# ---------------------------------------------------------------------------


def check_stream_attention(torch, gen, dev, cache: str):
    from live2diff_tpu_torch.ops.stream_attention import (
        plan, stream_window_attention_bf16, stream_window_attention_int8,
        stream_window_attention_plain,
    )

    s, heads, window = 2, 8, 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    # (C, HW, calls per 512x512 step, calls per 768x512 step): the 4 UNet
    # levels of each row, 10 calls each per stream step
    for c, hw, calls, calls_wide in (
        (320, 4096, 10, 0), (640, 1024, 10, 0), (1280, 256, 10, 0), (1280, 64, 10, 0),
        (320, 6144, 0, 10), (640, 1536, 0, 10), (1280, 384, 0, 10), (1280, 96, 0, 10),
    ):
        q = torch.randn(s, hw, c, generator=gen, device=dev).to(torch.bfloat16)
        extra = torch.randn(s, window, heads, hw, generator=gen, device=dev)
        extra[:, 9:] = float("-inf")  # an early-stream mask: slots 9..15 not visible
        pe_v = torch.randn(s, window, c, generator=gen, device=dev)
        if cache == "int8":
            data = torch.randint(-127, 128, (s, 2, window, c, hw), generator=gen, device=dev,
                                 dtype=torch.int8)
            scales = 0.002 + 0.02 * torch.rand(s, 2, window, c, generator=gen, device=dev)
            args = (q, data, scales, extra, pe_v, (c // heads) ** -0.5, heads)
            plain_args = args
            kernel = stream_window_attention_int8
            cache_bytes = data.numel() + 4 * scales.numel()
        else:
            data = torch.randn(s, 2, window, c, hw, generator=gen, device=dev).to(torch.bfloat16)
            args = (q, data, extra, pe_v, (c // heads) ** -0.5, heads)
            plain_args = (q, data, None, extra, pe_v, (c // heads) ** -0.5, heads)
            kernel = stream_window_attention_bf16
            cache_bytes = 2 * data.numel()
        out = kernel(*args)
        torch.cuda.synchronize()
        ref = stream_window_attention_plain(*plain_args)
        torch.cuda.synchronize()
        # the plain version rounds the (dequantised) K/V and the
        # probabilities to bf16 (~2^-9 each); the kernel keeps them in fp32
        err, rel = compare(out, ref, 2e-2)
        nbytes = 2 * q.numel() + cache_bytes + 4 * extra.numel() + 4 * pe_v.numel() + 2 * q.numel()
        flops = 6 * window * s * c * hw  # q.k, v (dequant) + pe, p.v
        b_ms, b_by = bound(nbytes, (flops, "fp32"))
        staging, cluster = plan(s, hw, c, heads, data.element_size(), sms)
        ms = time_ms(lambda: kernel(*args), 50)
        rows.append(dict(
            shape=f"q[{s},{hw},{c}] cache[{s},2,{window},{c},{hw}] {cache}", calls=calls,
            calls_768x512=calls_wide, prepare_calls=0, max_abs_err=err, rel_err=rel, tol=2e-2,
            route=f"{staging}, cluster {cluster}", ms=ms,
            plain_ms=time_ms(lambda: stream_window_attention_plain(*plain_args), 3),
            bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms, library_ms=None,
        ))
        del data, out, ref
    return rows


def check_flash(torch, gen, dev):
    import torch.nn.functional as F

    from live2diff_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    rows = []
    # (B, Sq, Sk, H, D, calls per stream step, calls in prepare). The stream
    # step: self- and cross-attention (77 text tokens) of the 2-step batch
    # at the 4 levels, and the DPT's ViT self-attention over 577 tokens,
    # 12 heads, in each of its 12 blocks. prepare(): spatial attention over
    # the 8 warmup frames (B = 8), the bidirectional motion attention over
    # those 8 frames with the positions folded into the batch (B = HW,
    # S = 8), and the ViT over the 8 warmup frames.
    # calls per 768x512 step: the same at that row's levels (S = 6144, 1536,
    # 384, 96) and the ViT, whose input is 384x384 at either size
    for b, sq, sk, h, d, calls, calls_wide, prep in (
        (2, 4096, 4096, 8, 40, 5, 0, 0), (2, 1024, 1024, 8, 80, 5, 0, 0),
        (2, 256, 256, 8, 160, 5, 0, 0), (2, 64, 64, 8, 160, 1, 0, 0),
        (2, 4096, 77, 8, 40, 5, 0, 0), (2, 1024, 77, 8, 80, 5, 0, 0),
        (2, 256, 77, 8, 160, 5, 0, 0), (2, 64, 77, 8, 160, 1, 0, 0),
        (1, 577, 577, 12, 64, 12, 12, 0),
        (2, 6144, 6144, 8, 40, 0, 5, 0), (2, 1536, 1536, 8, 80, 0, 5, 0),
        (2, 384, 384, 8, 160, 0, 5, 0), (2, 96, 96, 8, 160, 0, 1, 0),
        (2, 6144, 77, 8, 40, 0, 5, 0), (2, 1536, 77, 8, 80, 0, 5, 0),
        (2, 384, 77, 8, 160, 0, 5, 0), (2, 96, 77, 8, 160, 0, 1, 0),
        (8, 4096, 4096, 8, 40, 0, 0, 10), (4096, 8, 8, 8, 40, 0, 0, 20),
        (1024, 8, 8, 8, 80, 0, 0, 20), (256, 8, 8, 8, 160, 0, 0, 20), (64, 8, 8, 8, 160, 0, 0, 20),
        (8, 577, 577, 12, 64, 0, 0, 12),
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
                           (4 * b * h * sq * sk * d, "bf16"), exps=b * h * sq * sk)
        rows.append(dict(
            shape=f"q[{b},{sq},{h},{d}] k[{b},{sk},{h},{d}]", calls=calls,
            calls_768x512=calls_wide, prepare_calls=prep,
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

    # (B, H, W, Cin, bias, skip+ReLU, calls per 512x512 stream step, calls
    # per 768x512 step, calls in prepare): a step encodes the frame and its
    # depth image as one batch (B = 2: 31 stride-1 calls, 4 of them at full
    # size, 9 at each other level) and decodes one frame (B = 1: 33 calls,
    # 4 / 10 / 10 / 9 from full size down); prepare() encodes 8 frames and
    # their 8 depth images (B = 16) and decodes 8 frames (B = 8) at 512x512,
    # largest level shown
    if stride == 1:
        shapes = ((2, 512, 512, 3, True, False, 1, 0, 0), (2, 512, 512, 64, True, True, 3, 0, 0),
                  (2, 256, 256, 64, True, True, 9, 0, 0), (2, 128, 128, 64, True, True, 9, 0, 0),
                  (2, 64, 64, 64, True, True, 9, 0, 0), (1, 512, 512, 64, True, True, 4, 0, 0),
                  (1, 256, 256, 64, True, True, 10, 0, 0), (1, 128, 128, 64, True, True, 10, 0, 0),
                  (1, 64, 64, 64, True, True, 9, 0, 0),
                  (2, 512, 768, 3, True, False, 0, 1, 0), (2, 512, 768, 64, True, True, 0, 3, 0),
                  (2, 256, 384, 64, True, True, 0, 9, 0), (2, 128, 192, 64, True, True, 0, 9, 0),
                  (2, 64, 96, 64, True, True, 0, 9, 0), (1, 512, 768, 64, True, True, 0, 4, 0),
                  (1, 256, 384, 64, True, True, 0, 10, 0), (1, 128, 192, 64, True, True, 0, 10, 0),
                  (1, 64, 96, 64, True, True, 0, 9, 0),
                  (16, 512, 512, 3, True, False, 0, 0, 1), (16, 512, 512, 64, True, True, 0, 0, 3),
                  (8, 512, 512, 64, True, True, 0, 0, 4))
    else:  # the three encoder downsamples: no bias, no ReLU
        shapes = ((2, 512, 512, 64, False, False, 1, 0, 0), (2, 256, 256, 64, False, False, 1, 0, 0),
                  (2, 128, 128, 64, False, False, 1, 0, 0), (2, 512, 768, 64, False, False, 0, 1, 0),
                  (2, 256, 384, 64, False, False, 0, 1, 0), (2, 128, 192, 64, False, False, 0, 1, 0),
                  (16, 512, 512, 64, False, False, 0, 0, 1))
    rows = []
    for nb, h, wd, cin, has_bias, fused, calls, calls_wide, prep in shapes:
        x = torch.randn(nb, h, wd, cin, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(64, cin, 3, 3, generator=gen, device=dev) / (9 * cin) ** 0.5
             ).to(torch.bfloat16)
        bias = torch.randn(64, generator=gen, device=dev).to(torch.bfloat16) if has_bias else None
        ho, wo = h // stride, wd // stride
        skip = (torch.randn(nb, ho, wo, 64, generator=gen, device=dev).to(torch.bfloat16)
                if fused else None)
        args = (x, w, bias, skip, fused, stride)
        out = conv3x3(*args)
        torch.cuda.synchronize()
        ref = conv3x3_plain(*args)
        torch.cuda.synchronize()
        # same bf16 operands and fp32 sums in another order; bf16 output rounding
        err, rel = compare(out, ref, 1e-2)
        out_elems = nb * ho * wo * 64
        nbytes = 2 * (x.numel() + w.numel() + 64 * has_bias + out_elems * (1 + fused))
        b_ms, b_by = bound(nbytes, (2 * out_elems * 9 * cin, "bf16"))
        # channels-last views for cuDNN, the weight's copy made once, untimed
        x_cl = x.permute(0, 3, 1, 2)
        w_cl = w.contiguous(memory_format=torch.channels_last)
        rows.append(dict(
            shape=f"x[{nb},{h},{wd},{cin}] stride {stride}" + (" +skip+relu" if fused else ""),
            calls=calls, calls_768x512=calls_wide, prepare_calls=prep, max_abs_err=err,
            rel_err=rel, tol=1e-2,
            ms=time_ms(lambda: conv3x3(*args), 50),
            plain_ms=time_ms(lambda: conv3x3_plain(*args), 5),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.conv2d(x_cl, w_cl, bias, stride, 1), 50),
            library="F.conv2d, channels-last: the conv and bias only (no skip add, no ReLU)",
        ))
    return rows


def layer_norm_row(torch, gen, dev, n, c, eps, label="", **calls):
    """The LayerNorm kernel's wrapper against its plain version at x [n, C]
    bf16; ``calls``: the row's call counts."""
    import torch.nn.functional as F

    from live2diff_tpu_torch.ops.norm import layer_norm_plain, layer_norm_rows

    x = (torch.randn(n, c, generator=gen, device=dev) * 2.0 + 0.5).to(torch.bfloat16)
    g = (1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
    b = (0.1 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
    out = layer_norm_rows(x, g, b, eps)
    torch.cuda.synchronize()
    ref = layer_norm_plain(x, g, b, eps)
    torch.cuda.synchronize()
    # same fp32 statistics in another order; one bf16 rounding of the output
    err, rel = compare(out, ref, 1e-2)
    b_ms, b_by = bound(2 * (2 * x.numel() + 2 * c), (8 * x.numel(), "fp32"))
    return dict(
        shape=f"x[{n},{c}] bf16 eps {eps:g}{label}", **calls,
        max_abs_err=err, rel_err=rel, tol=1e-2,
        ms=time_ms(lambda: layer_norm_rows(x, g, b, eps), 100),
        plain_ms=time_ms(lambda: layer_norm_plain(x, g, b, eps), 20),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.layer_norm(x, (c,), g, b, eps), 100),
    )


def check_layer_norm(torch, gen, dev):
    """The main path's LayerNorms: (rows, calls per stream step, calls in
    prepare) of the ViT's 2 LayerNorms in each of its 12 blocks over 577
    tokens per frame (1 frame a step, the 8 warmup frames in prepare), and
    one ragged shape."""
    return [layer_norm_row(torch, gen, dev, n, 768, 1e-6, calls=calls, prepare_calls=prep)
            for n, calls, prep in ((577, 24, 0), (577 * 8, 0, 24), (1001, 0, 0))]


def check_layer_norm_sites(torch, gen, dev, step_shapes, prepare_shapes):
    """The LayerNorm kernel at every (rows, C, eps) that phase 10's stream
    step and prepare (``ln_kernel_sites="all"``) gave it, with its calls
    there (``calls_ln_all``, ``prepare_calls_ln_all``; none on the main
    path). The logs are keyed by (site, rows, C, eps)."""
    step, prep, sites = Counter(), Counter(), defaultdict(set)
    for log, into in ((step_shapes, step), (prepare_shapes, prep)):
        for (site, n, c, eps), k in log.items():
            into[n, c, eps] += k
            sites[n, c, eps].add(site)
    return [layer_norm_row(torch, gen, dev, n, c, eps, f" ({', '.join(sorted(sites[n, c, eps]))})",
                           calls=0, prepare_calls=0, calls_ln_all=step[n, c, eps],
                           prepare_calls_ln_all=prep[n, c, eps])
            for n, c, eps in sorted(sites)]


# The [B, H, S, D] flash entries round p to bf16 from the same fp32 logits
# and the same block max as their plain versions (for #5: the same int8
# codes and an exact integer Q.K), so only the order of fp32 sums differs.
# Their max error relative to max |plain| is set by single bf16 roundings of
# the output that land on the other side (up to 2^-7 at the largest
# element); their relative RMS error, by how many outputs do. Leaving out
# #5's quantisation (its bf16 Q.K) moves the output by ~1e-2 in both
# measures: the script measures that gap at each shape and requires it to
# exceed INT8_MAX_TOL and 5 x VARIANT_RMS_TOL, so these tolerances tell the
# int8 function from the bf16 one.
VARIANT_RMS_TOL = 1e-3
SMAJOR_MAX_TOL = 2e-2  # as #3 against its plain version
INT8_MAX_TOL = 8e-3


def check_flash_variant(torch, gen, dev, variant: str):
    """The s-major or int8-QK flash entry at the gated self-attention
    shapes of both resolutions: ``[B, H, S, D]`` views of the model's
    ``[B, S, H, D]`` (no copy), with the dispatch's blocks. For int8, also
    the gap between the plain int8 version and the unquantised one (the
    s-major plain version with the same blocks)."""
    import torch.nn.functional as F

    from live2diff_tpu_torch.ops import flash_attention as fa

    if variant == "smajor":
        kernel, plain = fa.flash_self_attention, fa.flash_self_attention_plain
        block_k = lambda s: 1024  # noqa: E731
        library_note = "scaled_dot_product_attention (the same function)"
        max_tol = SMAJOR_MAX_TOL
    else:
        kernel, plain = fa.flash_self_attention_int8, fa.flash_self_attention_int8_plain
        block_k = lambda s: min(s, 4096)  # noqa: E731
        library_note = "scaled_dot_product_attention in bf16: NOT the same function (no int8 QK)"
        max_tol = INT8_MAX_TOL
    # phase 6 runs int8 at 512x512, phase 8 s-major at 768x512; each
    # variant is also checked at the other resolution's shapes
    runs_512 = variant == "int8"
    rows = []
    # (B, S, D, calls per stream step, calls in prepare): 5 self-attentions
    # a step at each of the two top levels (B = 2 steps), 10 in prepare
    # (two warmup forwards over the 8 frames folded into the batch)
    for b, s, d, calls, prep in (
        (2, 4096, 40, 5 * runs_512, 0), (2, 1024, 80, 5 * runs_512, 0),
        (8, 4096, 40, 0, 10 * runs_512), (8, 1024, 80, 0, 10 * runs_512),
        (2, 6144, 40, 5 * (not runs_512), 0), (2, 1536, 80, 5 * (not runs_512), 0),
        (8, 6144, 40, 0, 10 * (not runs_512)), (8, 1536, 80, 0, 10 * (not runs_512)),
    ):
        h = 8
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev).to(torch.bfloat16)
                   .transpose(1, 2) for _ in range(3))
        scale, bk = d ** -0.5, block_k(s)
        out = kernel(q, k, v, scale, 512, bk)
        torch.cuda.synchronize()
        ref = plain(q, k, v, scale, 512, bk)
        torch.cuda.synchronize()
        err, rel = compare(out, ref, max_tol)
        rms = rel_rms(out, ref)
        if not rms <= VARIANT_RMS_TOL:
            raise AssertionError(f"{variant} flash: relative RMS error {rms:.3e} > {VARIANT_RMS_TOL}")
        gap = {}
        if variant == "int8":
            # the pre-pass's codes and scales, bit for bit, and its share of the time
            q8, s_q, k8, s_k = fa.quantize_groups_cuda(q, k, 512, bk)
            for codes, scales, x, blk in ((q8, s_q, q, 512), (k8, s_k, k, bk)):
                ref_codes, ref_scales = fa.quantize_groups(x, fa.pick_block(s, blk))
                if not (torch.equal(scales, ref_scales) and torch.equal(codes.float(), ref_codes)):
                    raise AssertionError(f"int8 flash pre-pass at q[{b},{h},{s},{d}]: codes or "
                                         f"scales differ from quantize_groups")
            del q8, k8, ref_codes
            gap["prepass_ms"] = time_ms(lambda: fa.quantize_groups_cuda(q, k, 512, bk), 20)
            unq = fa.flash_self_attention_plain(q, k, v, scale, 512, bk)
            gap.update(unquantised_rel_err=compare(unq, ref, float("inf"))[1],
                       unquantised_rms_err=rel_rms(unq, ref))
            del unq
            if not (gap["unquantised_rel_err"] > INT8_MAX_TOL
                    and gap["unquantised_rms_err"] > 5 * VARIANT_RMS_TOL):
                raise AssertionError(f"int8 flash: the tolerances do not resolve the quantisation "
                                     f"at this shape: {gap}")
        nbytes = 2 * 4 * q.numel()
        work = 2 * b * h * s * s * d  # each of the two products
        if variant == "int8":
            b_ms, b_by = bound(nbytes, (work, "int8"), (work, "bf16"), exps=b * h * s * s)
        else:
            b_ms, b_by = bound(nbytes, (2 * work, "bf16"), exps=b * h * s * s)
        rows.append(dict(
            shape=f"q[{b},{h},{s},{d}] blocks (512, {fa.pick_block(s, bk)})", calls=calls,
            prepare_calls=prep, max_abs_err=err, rel_err=rel, tol=max_tol, rms_err=rms,
            rms_tol=VARIANT_RMS_TOL, **gap,
            ms=time_ms(lambda: kernel(q, k, v, scale, 512, bk), 20),
            plain_ms=time_ms(lambda: plain(q, k, v, scale, 512, bk), 2),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20),
            library=library_note,
        ))
    return rows


def launch_floor_ms(torch, _build) -> float:
    """The per-call time of an empty kernel (one warp, no work) by
    ``time_ms``: the floor under calls that sit near launch latency."""
    import ctypes

    fn = _build.load("layer_norm").layer_norm_empty_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        _build.check(fn(torch.cuda.current_stream().cuda_stream), "empty kernel")

    return time_ms(launch, 100)


def check_quantize_kv(torch):
    """The int8 KV cache's quantisation (``models/motion.py:_quantize_kv``)
    on the card against the CPU, bit for bit, at the four ``[2, HW, C]``
    cache writes of a 512x512 step. Returns the shapes checked."""
    from live2diff_tpu_torch.models.motion import _quantize_kv

    shapes = []
    for c, hw in ((320, 4096), (640, 1024), (1280, 256), (1280, 64)):
        gen = torch.Generator().manual_seed(c + hw)
        x = (torch.randn(2, hw, c, generator=gen) * torch.rand(1, 1, c, generator=gen) * 4
             ).to(torch.bfloat16)
        codes, scales = _quantize_kv(x.cuda(), 1)
        codes_cpu, scales_cpu = _quantize_kv(x, 1)
        if not (torch.equal(scales.cpu(), scales_cpu) and torch.equal(codes.cpu(), codes_cpu)):
            raise AssertionError(f"_quantize_kv at [2, {hw}, {c}]: card and CPU differ")
        shapes.append(f"[2, {hw}, {c}] bit-equal")
    return shapes


GN_ACTS = {"silu": "F.silu", "relu": "torch.relu", "none": "identity"}


def check_group_norm(torch, gen, dev, step_shapes, prepare_shapes):
    """The GroupNorm kernel at every (B, T, C, groups, eps, act) that phase
    7's stream step and prepare gave it, with its calls there: its plan's
    route (every step shape must be resident), its time by events and by
    the profiler's device time, and its share of the bound."""
    import torch.nn.functional as F

    from live2diff_tpu_torch.ops.norm import (
        gn_device_limits, group_norm, group_norm_plain, group_norm_plan,
    )

    acts = {"silu": F.silu, "relu": torch.relu, "none": lambda y: y}
    rows = []
    for key in sorted(set(step_shapes) | set(prepare_shapes)):
        b, t, c, groups, eps, act = key
        x = (torch.randn(b, t, c, generator=gen, device=dev) * 3.0 + 2.0).to(torch.bfloat16)
        g = (1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        bt = (0.1 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        args = (x, g, bt, groups, eps, act)
        out = group_norm(*args)
        torch.cuda.synchronize()
        ref = group_norm_plain(*args)
        torch.cuda.synchronize()
        # the same fp32 centred statistics merged in another order; one
        # bf16 rounding of the output
        err, rel = compare(out, ref, 1e-2)
        plan = group_norm_plan(b, t, c, groups, *gn_device_limits(dev.index or 0))
        if step_shapes.get(key, 0) and not plan.resident:
            raise AssertionError(f"group_norm at the step shape x[{b},{t},{c}]: {plan}, "
                                 f"not resident")
        x_cf = x.permute(0, 2, 1).contiguous()  # channels-first copy, made once
        # x read once, y written once (bf16); ~10 fp32 operations an element
        b_ms, b_by = bound(2 * (2 * x.numel() + 2 * c), (10 * x.numel(), "fp32"))
        ms = time_ms(lambda: group_norm(*args), 50)
        dev_ms = device_ms(lambda: group_norm(*args), 50, "group_norm_kernel")
        rows.append(dict(
            shape=f"x[{b},{t},{c}] G{groups} eps {eps:g} {act}",
            calls=step_shapes.get(key, 0), prepare_calls=prepare_shapes.get(key, 0),
            max_abs_err=err, rel_err=rel, tol=1e-2,
            route=f"{plan.route}, {plan.ctas} CTAs x {plan.tiles_per_cta} tiles of "
                  f"{plan.rows} rows", ms=ms, device_ms=dev_ms,
            plain_ms=time_ms(lambda: group_norm_plain(*args), 5),
            bound_ms=b_ms, bound_by=b_by,
            bound_share=b_ms / ms, device_bound_share=(
                b_ms / dev_ms if isinstance(dev_ms, float) else "not measured"),
            library_ms=time_ms(lambda: acts[act](F.group_norm(x_cf, groups, g, bt, eps)), 50),
            library=f"F.group_norm + {GN_ACTS[act]} on a channels-first copy (copy not timed)",
        ))
    return rows


# per-step totals besides the main path's: {total's key: (the rows' calls
# key, the step's name)}
OTHER_STEPS = {"per_768x512_step": ("calls_768x512", "768x512 step"),
               "per_ln_all_step": ("calls_ln_all", "phase 10 step")}


def summarise(name, source, replaces, rows):
    """One kernels-line entry: per-step totals (sum over shapes of calls x
    per-call time) and the per-shape rows."""
    def total(key):
        vals = [r[key] for r in rows]
        return None if any(v is None for v in vals) else sum(r["calls"] * r[key] for r in rows)

    by_bytes = sum(r["calls"] * r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
    by_ops = sum(r["calls"] * r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    wide = {  # the same totals over a 768x512 step, or a step of phase 10
        total: {key: None if any(r[key] is None for r in rows)
                else sum(r.get(calls, 0) * r[key] for r in rows)
                for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        for total, (calls, _) in OTHER_STEPS.items() if any(calls in r for r in rows)}
    return dict(
        name=name, route="cuda", source=source, replaces=replaces, launches=None,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
        bound_by="bytes" if by_bytes >= by_ops else "operations",
        library_ms=total("library_ms"), per="stream step (sum over shapes of calls x ms)",
        **wide, shapes=rows,
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


# the narrow DPT of tests/_torch_parity.py at the 384x384 input the stream fixes
SMALL_DPT = dict(image_size=384, patch_grid=24, vit_hidden=16, vit_layers=2, vit_heads=2,
                 vit_mlp=32, hooks=(0, 1), resnet_layers=(1, 1, 1), features=8)


def small_input_check(torch):
    from live2diff_tpu_torch.builder import build_pipeline
    from live2diff_tpu_torch.models.midas import DPTConfig, DPTDepthModel
    from live2diff_tpu_torch.stream.pipeline import StreamDiffusionDepth

    gen = torch.Generator().manual_seed(5)
    dpt = DPTDepthModel(DPTConfig(**SMALL_DPT))
    fan_in_init_(dpt, gen)

    def build(device, dtype):
        b = build_pipeline(SMALL_CONFIG, 64, 64, dtype=dtype, kv_cache_dtype="int8",
                           seed=0, device=device, unet_overrides=SMALL_UNET, use_depth=False)
        depth = DPTDepthModel(DPTConfig(**SMALL_DPT))
        depth.load_state_dict(dpt.state_dict())
        depth = depth.to(device=device, dtype=dtype).eval()
        stream = StreamDiffusionDepth(b.unet, b.vae, b.schedule, b.stream_config,
                                      torch.device(device), dtype, depth_model=depth)
        return b, stream

    (ref, ref_stream), (card, card_stream) = build("cpu", torch.float32), build("cuda", torch.bfloat16)
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

    with torch.no_grad():
        depth_ref = ref_stream._depth_image(warm)
        depth_card = card_stream._depth_image(warm.cuda())
    depth_err = rel_rms(depth_card, depth_ref)
    if not depth_ref.std() > 0.05:
        raise AssertionError(f"small input: flat depth image (std {depth_ref.std():.3g})")
    s_ref, w_ref = ref_stream.prepare(warm, prompt, noise=noise(10))
    s_card, w_card = card_stream.prepare(warm, prompt, noise=noise(10))
    errs = [rel_rms(w_card, w_ref)]
    for i, f in enumerate(frames):
        s_ref, o_ref = ref_stream(s_ref, f, noise=noise(100 + i))
        s_card, o_card = card_stream(s_card, f, noise=noise(100 + i))
        if not torch.isfinite(o_card).all():
            raise AssertionError(f"small input: frame {i} not finite")
        errs.append(rel_rms(o_card, o_ref))
    torch.cuda.synchronize()
    if not max(errs + [depth_err]) <= SMALL_TOL:
        raise AssertionError(
            f"small input: rel RMS errors {errs} (depth image {depth_err}) exceed {SMALL_TOL}")
    return errs, depth_err, float(depth_ref.std())


# ---------------------------------------------------------------------------
# phases 4 and 5: streams at full width
# ---------------------------------------------------------------------------


def check_counts(what, counts, expected, per: int):
    for name, n in expected.items():
        if counts[name] != n * per:
            raise AssertionError(
                f"{what}: {name} launched {counts[name]} times, expected {n} x {per}")


def group_norm_recorder(torch, modules):
    """Forward pre-hooks on every FusedGroupNorm of ``modules`` that log
    (B, T, C, groups, eps, act) of each call meeting the JAX package's
    kernel conditions (``live2diff_tpu/ops/norm.py:140-147``: T * C <=
    3 * 2^20, C % groups == 0, C % 8 == 0) and the kernel's widest row
    (C <= GN_MAX_CHANNELS, wider than any model's). Returns (log, remove)."""
    from live2diff_tpu_torch.models.layers import FusedGroupNorm
    from live2diff_tpu_torch.models.resnet import InflatedGroupNorm
    from live2diff_tpu_torch.ops.norm import GN_MAX_CHANNELS, GN_MAX_ELEMS

    log = []

    def hook(mod, args):
        x = args[0]
        c = x.shape[-1]
        # InflatedGroupNorm folds its frame axis into the batch
        n = x.shape[0] * x.shape[1] if isinstance(mod, InflatedGroupNorm) else x.shape[0]
        t = x.numel() // (n * c)
        if (t * c <= GN_MAX_ELEMS and c % mod.num_groups == 0 and c % 8 == 0
                and c <= GN_MAX_CHANNELS):
            log.append((n, t, c, mod.num_groups, mod.eps, mod.act))

    handles = [m.register_forward_pre_hook(hook) for mod in modules for m in mod.modules()
               if isinstance(m, FusedGroupNorm)]
    return log, lambda: [h.remove() for h in handles]


def layer_norm_recorder(torch, modules):
    """Forward pre-hooks on every FusedLayerNorm of ``modules`` that log
    (site, rows, C, eps) of each call meeting the JAX package's kernel
    conditions at a site the module's choices name
    (``live2diff_tpu/ops/norm.py:239-246``: C % 8 == 0, at least 2^14
    elements). Returns (log, remove)."""
    from live2diff_tpu_torch.models.layers import FusedLayerNorm
    from live2diff_tpu_torch.ops.norm import LN_MIN_ELEMS

    log = []

    def hook(mod, args):
        x = args[0]
        if (mod.kernels.ln_kernel_at(mod.site) and x.shape[-1] % 8 == 0
                and x.numel() >= LN_MIN_ELEMS):
            c = x.shape[-1]
            log.append((mod.site, x.numel() // c, c, mod.eps))

    handles = [m.register_forward_pre_hook(hook) for mod in modules for m in mod.modules()
               if isinstance(m, FusedLayerNorm)]
    return log, lambda: [h.remove() for h in handles]


def run_stream(torch, _build, n_frames, expected_step, expected_prepare, profile,
               height=512, width=512, record_gn=False, record_ln=False, keep=None,
               **build_kw):
    """build_pipeline at full width, prepare, then ``n_frames`` frames, each
    timed on the host clock to a synchronize; launch counts are zeroed just
    before prepare and before the frames, and asserted just after each.
    With ``record_gn`` (``record_ln``) the GroupNorm (LayerNorm) calls that
    meet the kernel conditions are logged over prepare and the (untimed)
    warm step, and ``group_norm`` (``layer_norm``) is expected to launch
    once for each of them. ``keep``, a list, gets the stream, its state and
    the frames, for ``interleaved``."""
    from live2diff_tpu_torch.builder import build_pipeline
    from live2diff_tpu_torch.ops import norm, stream_attention

    dev = torch.device("cuda")
    gc.collect()  # an earlier phase's pipeline, freed before this one is built
    torch.cuda.empty_cache()
    allocated_at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    built = build_pipeline(BENCH_CONFIG, height, width, dtype=torch.bfloat16,
                           output_uint8=True, seed=0, device=dev, **build_kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    stream = built.stream
    n_params = {"unet": sum(p.numel() for p in built.unet.parameters())}
    if built.depth_model is not None:
        n_params["depth"] = sum(p.numel() for p in built.depth_model.parameters())
    recorders = {}  # kernel name -> (log, remove) of its hooks
    models = [m for m in (built.unet, built.depth_model) if m is not None]
    if record_gn:
        recorders["group_norm"] = group_norm_recorder(torch, models)
    if record_ln:
        recorders["layer_norm"] = layer_norm_recorder(torch, models)

    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.randn(1, 77, 768, generator=gen, device=dev)
    warm = torch.rand(8, height, width, 3, generator=gen, device=dev) * 2 - 1
    frames = torch.randint(0, 256, (n_frames, height, width, 3), generator=gen, device=dev,
                           dtype=torch.uint8)

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state, warm_out = stream.prepare(warm, prompt, seed=2)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    warm_counts = dict(_build.launch_counts)
    if warm_out.shape != (8, height, width, 3) or warm_out.dtype != torch.uint8:
        raise AssertionError(f"warmup output {tuple(warm_out.shape)} {warm_out.dtype}")
    if len(state.kv_caches) != 40:
        raise AssertionError(f"prepare() left {len(state.kv_caches)} KV caches, expected 40")
    int8 = isinstance(state.kv_caches[0], tuple)
    finite = [torch.isfinite(c[1] if int8 else c).all() for c in state.kv_caches]
    if not all(finite):
        raise AssertionError("prepare() left non-finite KV caches (or int8 scales)")
    logged_prepare = {}
    for name, (log, _) in recorders.items():
        logged_prepare[name] = Counter(log)
        log.clear()
        expected_prepare = {**expected_prepare, name: sum(logged_prepare[name].values())}
    check_counts("prepare", warm_counts, expected_prepare, 1)
    peak_prepare = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # the warm step runs on a throwaway state: a second set of KV caches
    first_step_s = stream.warm_frame_step(torch.uint8)
    peak_warm_step = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logged_step = {}
    for name, (log, remove_hooks) in recorders.items():
        logged_step[name] = Counter(log)
        remove_hooks()
        expected_step = {**expected_step, name: sum(logged_step[name].values())}

    _build.reset_launch_counts()
    routes_before = dict(stream_attention.route_counts)
    gn_routes_before = dict(norm.gn_route_counts)
    times, outs = [], []
    for i in range(n_frames):
        t0 = time.perf_counter()
        state, out = stream(state, frames[i])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
        # uint8 frames cannot show a NaN: check the latents the step made
        if not torch.isfinite(state.x_t_buffer).all():
            raise AssertionError(f"frame {i}: non-finite latents")
    counts = dict(_build.launch_counts)
    routes = {k: v - routes_before[k] for k, v in stream_attention.route_counts.items()}
    gn_routes = {k: v - gn_routes_before[k] for k, v in norm.gn_route_counts.items()}
    peak_stream = torch.cuda.max_memory_allocated()
    for out in outs:
        if out.shape != (height, width, 3) or out.dtype != torch.uint8:
            raise AssertionError(f"frame output {tuple(out.shape)} {out.dtype}")
    check_counts(f"{n_frames} stream steps", counts, expected_step, n_frames)
    if not torch.isfinite(state.depth_buffer).all():
        raise AssertionError("non-finite depth latents")
    steady = sorted(times[2:])
    result = dict(
        frame=f"{width}x{height}", params=n_params, build_s=build_s, prepare_s=prepare_s,
        first_step_s=first_step_s, frames=n_frames,
        frame_ms_p50=statistics.median(steady),
        frame_ms_p90=steady[int(0.9 * (len(steady) - 1))],
        frame_ms_all=times,
        fps_p50=1e3 / statistics.median(steady),
        # peak device memory from the build on (the warm step included), and
        # over prepare alone and the streamed frames alone, above what was
        # allocated before the build (the script's buffers, kept pipelines)
        max_memory_allocated_bytes=max(peak_prepare, peak_warm_step, peak_stream)
        - allocated_at_start,
        max_memory_prepare_bytes=peak_prepare - allocated_at_start,
        max_memory_stream_bytes=peak_stream - allocated_at_start,
        memory_allocated_at_start_bytes=allocated_at_start,
        outputs_uint8=True,
        output_mean=float(torch.stack(outs).float().mean()),
        output_std=float(torch.stack(outs).float().std()),
        launches_prepare=warm_counts,
        launches_stream=counts,
        launches_per_step={k: v / n_frames for k, v in counts.items()},
        stream_attention_routes_per_step={k: v / n_frames for k, v in routes.items()},
        group_norm_routes_per_step={k: v / n_frames for k, v in gn_routes.items()},
    )
    if record_gn:
        result["group_norm_shapes"] = (logged_step["group_norm"], logged_prepare["group_norm"])
    if record_ln:
        result["layer_norm_sites"] = (logged_step["layer_norm"], logged_prepare["layer_norm"])
    if built.depth_model is not None:
        result["raw_depth"] = raw_depth_stats(torch, stream, frames[:4])
    if keep is not None:
        keep.append((stream, state, frames))
    if profile:
        result["profile"] = prof = profile_steps(torch, stream, state, frames[:4])
        if isinstance(prof["device_ms_per_call"], float):
            # the profiler slows the host; the busy share of an unprofiled step
            prof["device_ms_over_frame_ms_p50"] = prof["device_ms_per_call"] / result["frame_ms_p50"]
        if built.depth_model is not None:
            result["depth_profile"] = dprof = profile_depth(torch, stream, frames[:4])
            if isinstance(dprof["device_ms_per_call"], float):
                dprof["share_of_step_device_ms"] = (dprof["device_ms_per_call"]
                                                    / prof["device_ms_per_call"])
                dprof["share_of_step_kernels"] = (dprof["kernels_per_call"]
                                                  / prof["kernels_per_call"])
    return result, counts


def interleaved(torch, runs, rounds):
    """Frame times of several pipelines streamed in turn, one frame each a
    round, the order rotated every round, so that the host's drift over the
    run falls on all of them alike. ``runs``: {name: (stream, state,
    frames)}. Returns {name: {p50, p90, wins}}, ``wins`` counting the rounds
    in which that pipeline's frame was the fastest."""
    names = list(runs)
    states = {n: runs[n][1] for n in names}
    times = {n: [] for n in names}
    for r in range(rounds):
        order = names[r % len(names):] + names[:r % len(names)]
        for n in order:
            stream, _, frames = runs[n]
            t0 = time.perf_counter()
            states[n], _ = stream(states[n], frames[r % len(frames)])
            torch.cuda.synchronize()
            times[n].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for n in names:
        srt = sorted(times[n])
        wins = sum(times[n][r] == min(times[m][r] for m in names) for r in range(rounds))
        out[n] = dict(frame_ms_p50=statistics.median(srt),
                      frame_ms_p90=srt[int(0.9 * (len(srt) - 1))], fastest_in_rounds=wins,
                      rounds=rounds)
    return out


def raw_depth_stats(torch, stream, frames):
    """min, max and std of the DPT's raw output for a few stream frames,
    before the stream's min-max normalisation."""
    from live2diff_tpu_torch.models.midas import resize_nhwc

    with torch.no_grad():
        x = resize_nhwc(frames.float() / 127.5 - 1.0, stream.DEPTH_SIZE, stream.DEPTH_SIZE)
        depth = stream.depth_model(x.to(stream.dtype)).float()
    return [dict(min=float(d.min()), max=float(d.max()), std=float(d.std())) for d in depth]


def profile_device(torch, call, n):
    """torch.profiler over ``n`` calls of ``call()``: device time and kernel
    launches per call by kernel name (and those of ``csrc/group_norm.cu``'s
    kernel), and the device-busy share of the wall time (which the
    profiler's own host overhead lowers)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            call()
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
    group_norm_kernels = sum(r[1] for r in rows if "group_norm_kernel" in r[2])
    return dict(
        calls=n, wall_ms_per_call=wall_ms,
        device_ms_per_call=device_ms if rows else "not measured",
        kernels_per_call=sum(r[1] for r in rows) if rows else "not measured",
        group_norm_kernels_per_call=group_norm_kernels if rows else "not measured",
        device_busy_share=device_ms / wall_ms if rows else "not measured",
        top=[dict(ms_per_call=r[0], launches_per_call=r[1], name=r[2][:90]) for r in rows[:25]],
    )


def profile_steps(torch, stream, state, frames):
    """The device profile of a few stream steps."""
    box, it = [state], iter(frames)

    def step():
        box[0], _ = stream(box[0], next(it))

    return profile_device(torch, step, len(frames))


def profile_depth(torch, stream, frames):
    """The device profile of the depth branch of a few stream steps: the
    512 -> 384 resize, the DPT, the min-max normalisation and the resize
    back, one frame a call."""
    it = iter(frames.float() / 127.5 - 1.0)
    with torch.no_grad():
        return profile_device(torch, lambda: stream._depth_image(next(it)[None]), len(frames))


def print_rows(k) -> None:
    for r in k["shapes"]:
        extra = "".join(f" {key} {r[key]:.2e}" for key in (
            "rms_err", "unquantised_rel_err", "unquantised_rms_err", "prepass_ms") if key in r)
        if r.get("calls_768x512"):
            extra += f" calls at 768x512 {r['calls_768x512']}"
        if "calls_ln_all" in r:
            extra += (f" calls in phase 10 {r['calls_ln_all']} a step, "
                      f"{r['prepare_calls_ln_all']} in prepare")
        if "route" in r:
            extra += f" route ({r['route']}) share of bound {r['bound_share']:.3f}"
        if "device_ms" in r:
            extra += f" device ms {r['device_ms']} (share of bound {r['device_bound_share']})"
        print(f"{k['name']:22s} {r['shape']:48s} rel {r['rel_err']:.2e} (tol {r['tol']}){extra} "
              f"ms {r['ms']:.4f} plain {r['plain_ms']:.3f} bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}) library {r['library_ms']}")
    totals = [("stream step", k)] + [(what, k[total]) for total, (_, what) in OTHER_STEPS.items()
                                     if total in k]
    for what, t in totals:
        print(f"{k['name']:22s} per {what}: ms {t['ms']:.4f} plain {t['plain_ms']:.3f} "
              f"bound {t['bound_ms']:.4f} library {t['library_ms']}")


def report_stream(result) -> None:
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("frame_ms_all", "raw_depth", "depth_profile")}))
    if "depth_profile" in result:
        print(f"depth branch profile: {json.dumps(result['depth_profile'])}")
    print(f"frame ms all: {[round(t, 3) for t in result['frame_ms_all']]}")
    if "raw_depth" in result:
        print(f"raw depth (min, max, std) of 4 stream frames: {json.dumps(result['raw_depth'])}")
    sys.stdout.flush()


def headline(result) -> dict:
    """Frame p50/p90 and, where profiled, device ms and kernels a step."""
    prof = result.get("profile", {})
    return dict(frame_ms_p50=result["frame_ms_p50"], frame_ms_p90=result["frame_ms_p90"],
                device_ms_per_step=prof.get("device_ms_per_call"),
                kernels_per_step=prof.get("kernels_per_call"))


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
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    SFU_RATE.append(SFU_PER_SM_CLOCK * sms * max_sm_mhz * 1e6)
    print(f"exponential rate for the flash bounds: {SFU_PER_SM_CLOCK} a clock x {sms} SMs x "
          f"{max_sm_mhz:g} MHz = {SFU_RATE[0]:.4g} / s")
    t0 = time.perf_counter()
    _build.build(_build.SOURCES)
    print(f"kernel build ({len(_build.SOURCES)} nvcc in parallel): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"plain references: {TF32_OFF}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)

    phase("kernels against their plain versions")
    src = "live2diff_tpu_torch/csrc/"
    kernels = [
        summarise("stream_attention_int8", src + "stream_attention.cu",
                  "live2diff_tpu/ops/stream_attention.py:198",
                  check_stream_attention(torch, gen, dev, "int8")),
        summarise("stream_attention_bf16", src + "stream_attention.cu",
                  "live2diff_tpu/ops/stream_attention.py:91",
                  check_stream_attention(torch, gen, dev, "bf16")),
        summarise("flash_attention", src + "flash_attention.cu",
                  "live2diff_tpu/ops/flash_attention.py:143", check_flash(torch, gen, dev)),
        summarise("flash_attention_smajor", src + "flash_attention.cu",
                  "live2diff_tpu/ops/flash_attention.py:317",
                  check_flash_variant(torch, gen, dev, "smajor")),
        summarise("flash_attention_int8", src + "flash_attention_int8.cu",
                  "live2diff_tpu/ops/flash_attention.py:256",
                  check_flash_variant(torch, gen, dev, "int8")),
        summarise("conv3x3", src + "conv3x3.cu",
                  "live2diff_tpu/ops/conv.py:492", check_conv(torch, gen, dev, 1)),
        summarise("conv3x3_s2", src + "conv3x3.cu",
                  "live2diff_tpu/ops/conv.py:507", check_conv(torch, gen, dev, 2)),
        summarise("layer_norm", src + "layer_norm.cu",
                  "live2diff_tpu/ops/norm.py:224", check_layer_norm(torch, gen, dev)),
    ]
    for k in kernels:
        print_rows(k)
    floor = launch_floor_ms(torch, _build)
    next(k for k in kernels if k["name"] == "layer_norm")["launch_floor_ms"] = floor
    print(f"launch floor: an empty kernel takes {floor:.4f} ms a call by the same timer ({smi})")
    print(f"int8 KV cache quantisation, card against CPU: {check_quantize_kv(torch)}")
    sys.stdout.flush()

    phase("small input: card (bf16, kernels) against CPU (fp32, plain), with a narrow DPT")
    errs, depth_err, depth_std = small_input_check(torch)
    print(f"per-frame relative RMS error, warmup then 12 frames: {errs}")
    print(f"depth image of the warmup frames: relative RMS error {depth_err}, std {depth_std}")

    phase("slice at full width: bench.py's main path (512x512, SD-1.5 motion UNet, TAESD, "
          "DPT-hybrid depth, int8 cache)")
    kept = []  # the three 512x512 int8-cache pipelines, streamed in turn after phase 7
    from live2diff_tpu_torch.ops import conv, flash_attention, stream_attention

    encode_stats = {"flash": (flash_attention.tensor_map_encode_stats, "3 maps each"),
                    "conv": (conv.tensor_map_encode_stats, "1 map each"),
                    "stream attention": (stream_attention.tensor_map_encode_stats,
                                         "1 map each")}
    before = {k: fn() for k, (fn, _) in encode_stats.items()}
    result, counts = run_stream(torch, _build, STREAM_FRAMES, EXPECTED_PER_STEP,
                                EXPECTED_PREPARE, profile=True, keep=kept, kv_cache_dtype="int8")
    report_stream(result)
    for k, (fn, maps) in encode_stats.items():
        ns, calls = (a - b for a, b in zip(fn(), before[k]))
        print(f"{k} tensor-map encoding on the host: {ns / 1e3 / calls:.3f} us a call over "
              f"the {calls} {k} launches of this phase that encoded maps ({maps})")
    # the main path's stream-attention launches by route, on a 132-SM H100:
    # every level on TMA; HW = 1024, 256 and 64 (128, 32 and 16 CTAs
    # without a cluster) in clusters of 2, 5 and 7, 10 calls a step each
    routes = result["stream_attention_routes_per_step"]
    print(f"stream attention routes a step: {json.dumps(routes)}")
    expected_routes = dict(MAIN_PATH_ROUTES)
    if sms != 132:  # another card: its cluster count is not pinned
        expected_routes["cluster"] = routes["cluster"]
    if routes != expected_routes:
        raise AssertionError(f"main path: stream attention routes {routes}, expected "
                             f"{expected_routes}")
    step_launches = result["profile"]["kernels_per_call"]
    print(f"profiled launches a stream step: {step_launches} (at most "
          f"{MAIN_PATH_LAUNCHES_PER_STEP})")
    if isinstance(step_launches, float) and step_launches > MAIN_PATH_LAUNCHES_PER_STEP:
        raise AssertionError(f"main path: {step_launches} launches a step, more than "
                             f"{MAIN_PATH_LAUNCHES_PER_STEP}")
    main_path = headline(result)
    del result

    phase("bf16 cache at full width, no depth (--kv-cache bf16 --no-depth)")
    result_bf16, counts_bf16 = run_stream(
        torch, _build, BF16_FRAMES, EXPECTED_PER_STEP_BF16,
        {"stream_attention_int8": 0, "layer_norm": 0, **OPT_IN_OFF},
        profile=False, kv_cache_dtype="bf16", use_depth=False)
    print(json.dumps({k: v for k, v in result_bf16.items() if k != "frame_ms_all"}))
    del result_bf16

    phase("int8 QK at full width: bench.py's --spatial-qk int8 (flash_variant='int8')")
    result, counts_int8 = run_stream(
        torch, _build, INT8_QK_FRAMES,
        with_variant(EXPECTED_PER_STEP, "flash_attention_int8", GATED_PER_STEP),
        with_variant(EXPECTED_PREPARE, "flash_attention_int8", GATED_PREPARE),
        profile=True, keep=kept, kv_cache_dtype="int8", flash_variant="int8")
    report_stream(result)
    print(f"beside phase 4: {json.dumps({'main path': main_path, 'int8 QK': headline(result)})}")
    del result

    phase("GroupNorm kernel at every site (gn_kernel_sites='all')")
    result, counts_gn = run_stream(torch, _build, GN_FRAMES, EXPECTED_PER_STEP, EXPECTED_PREPARE,
                                   profile=True, record_gn=True, keep=kept,
                                   kv_cache_dtype="int8", gn_kernel_sites="all")
    gn_step, gn_prepare = result.pop("group_norm_shapes")
    report_stream(result)
    gn_per_step = counts_gn["group_norm"] / GN_FRAMES
    print(f"group_norm launches: {gn_per_step} a step (one per "
          f"GroupNorm call meeting the kernel conditions), {sum(gn_prepare.values())} in prepare")
    # one device kernel a call, by the profile (a long trace may drop a
    # record: up to two more traces of the same stream, none may hold more
    # than one a call and one must hold exactly one); every step call resident
    prof = result["profile"]
    gn_kernels = [prof["group_norm_kernels_per_call"]]
    stream7, state7, frames7 = kept[-1]
    while (isinstance(prof["kernels_per_call"], float) and gn_kernels[-1] != gn_per_step
           and len(gn_kernels) < 3):
        gn_kernels.append(profile_steps(torch, stream7, state7, frames7[4:8])
                          ["group_norm_kernels_per_call"])
    print(f"profiled launches a stream step: {prof['kernels_per_call']} with the GroupNorm "
          f"kernel at every site, {main_path['kernels_per_step']} on the main path; "
          f"group_norm.cu kernels a step {gn_kernels} (traces taken); "
          f"routes a step {json.dumps(result['group_norm_routes_per_step'])}")
    if isinstance(prof["kernels_per_call"], float) and (
            gn_per_step not in gn_kernels or max(gn_kernels) > gn_per_step):
        raise AssertionError(f"GroupNorm: {gn_kernels} group_norm.cu device kernels a step in "
                             f"the profiles, {gn_per_step} calls")
    if result["group_norm_routes_per_step"]["streamed"]:
        raise AssertionError(f"GroupNorm: a stream step's call was not resident: "
                             f"{result['group_norm_routes_per_step']}")
    print(f"beside phase 4: {json.dumps({'main path': main_path, 'GN kernel': headline(result)})}")
    del result
    ab = interleaved(torch, dict(zip(("main path", "int8 QK", "GN kernel"), kept)),
                     INTERLEAVED_ROUNDS)
    print(f"phases 4, 6 and 7 streamed in turn: {json.dumps(ab)}")
    kept.clear()
    gn_entry = summarise("group_norm", src + "group_norm.cu", "live2diff_tpu/ops/norm.py:123",
                         check_group_norm(torch, gen, dev, gn_step, gn_prepare))
    dev_times = [r["device_ms"] for r in gn_entry["shapes"]]
    gn_entry["device_ms_per_step"] = (
        sum(r["calls"] * r["device_ms"] for r in gn_entry["shapes"])
        if all(isinstance(t, float) for t in dev_times) else "not measured")
    print_rows(gn_entry)
    print(f"group_norm per stream step: device ms {gn_entry['device_ms_per_step']} "
          f"(events {gn_entry['ms']}, bound {gn_entry['bound_ms']}) ({smi})")
    kernels.append(gn_entry)

    phase("768x512 at full width: bench.py's second row (d-major flash, as bench.py runs it)")
    result, _ = run_stream(torch, _build, WIDE_FRAMES, EXPECTED_PER_STEP, EXPECTED_PREPARE,
                           profile=True, height=512, width=768, kv_cache_dtype="int8")
    report_stream(result)
    wide = headline(result)
    del result

    phase("768x512 s-major A/B: phase 8 with flash_variant='smajor'")
    result, counts_smajor = run_stream(
        torch, _build, SMAJOR_FRAMES,
        with_variant(EXPECTED_PER_STEP, "flash_attention_smajor", GATED_PER_STEP),
        with_variant(EXPECTED_PREPARE, "flash_attention_smajor", GATED_PREPARE),
        profile=True, height=512, width=768, kv_cache_dtype="int8", flash_variant="smajor")
    report_stream(result)
    print(f"beside phase 8: {json.dumps({'d-major': wide, 's-major': headline(result)})}")
    del result

    phase("LayerNorm kernel at every site (ln_kernel_sites='all')")
    result, counts_ln = run_stream(torch, _build, LN_FRAMES, EXPECTED_PER_STEP, EXPECTED_PREPARE,
                                   profile=False, record_ln=True, kv_cache_dtype="int8",
                                   ln_kernel_sites="all")
    ln_step, ln_prepare = result.pop("layer_norm_sites")
    by_site = Counter()
    for (site, _, c, _), k in ln_step.items():
        by_site[site, c] += k
    print(f"layer_norm launches: {counts_ln['layer_norm'] / LN_FRAMES} a step (one per "
          f"LayerNorm call meeting the kernel conditions; by (site, C): "
          f"{json.dumps({f'{k[0]} {k[1]}': v for k, v in sorted(by_site.items())})}), "
          f"{sum(ln_prepare.values())} in prepare")
    if not by_site[("spatial", 1280)] or not by_site[("temporal", 1280)]:
        raise AssertionError(f"ln_kernel_sites='all': no kernel LayerNorm at C = 1280: {ln_step}")
    print(json.dumps({k: v for k, v in result.items() if k != "frame_ms_all"}))
    del result
    # the kernel against its plain version at every shape phase 10 gave it
    ln_index = next(i for i, k in enumerate(kernels) if k["name"] == "layer_norm")
    kernels[ln_index] = dict(summarise(
        "layer_norm", src + "layer_norm.cu", "live2diff_tpu/ops/norm.py:224",
        kernels[ln_index]["shapes"] + check_layer_norm_sites(torch, gen, dev, ln_step, ln_prepare)),
        launch_floor_ms=floor)
    print_rows(kernels[ln_index])

    # each kernel's launches come from the phase that runs it
    source_run = {"stream_attention_bf16": (counts_bf16, BF16_FRAMES, 5),
                  "flash_attention_int8": (counts_int8, INT8_QK_FRAMES, 6),
                  "group_norm": (counts_gn, GN_FRAMES, 7),
                  "flash_attention_smajor": (counts_smajor, SMAJOR_FRAMES, 9)}
    for k in kernels:
        run_counts, frames, ph = source_run.get(k["name"], (counts, STREAM_FRAMES, 4))
        k["launches"] = run_counts[k["name"]]
        k["launches_per_step"] = run_counts[k["name"]] / frames
        k["launches_phase"] = ph
        if not k["launches"]:
            raise AssertionError(f"{k['name']} was not launched on phase {ph}")

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
