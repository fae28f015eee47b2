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
   profiled launches a step may not exceed 7,265. The stream step is a
   CUDA graph, captured at the first frame and replayed at every frame, so
   in phases 4-10 a step's launches are asserted twice: (a) the wrappers'
   counts over the capture, which are one step's (the replays add none),
   and (b) each wrapper's device kernels by name in the profile of a few
   replays, per step (a trace that dropped a record is taken again, up to
   twice). The first call's time (capture and one replay) is reported
   apart from the steady frames. Prints the host time the
   flash kernels, the conv and stream attention spend encoding TMA tensor
   maps, per call.
5. bf16 cache: the same at full width with a bf16 KV cache and no depth
   model (``--kv-cache bf16 --no-depth``): ``prepare`` and 8 frames,
   profiled, with the bf16 stream-attention kernel's launches asserted.
6. int8 QK: phase 4 with ``flash_variant="int8"`` (bench.py's
   ``--spatial-qk int8``): 32 frames, profiled; the int8-QK flash kernel
   takes the 10 self-attentions a step that pass the flash gate.
7. GroupNorm kernel: phase 4 with ``gn_kernel_sites="all"``: 16 frames,
   profiled, beside phase 4's frame times and device profile; every
   GroupNorm module whose input meets the JAX conditions launches the
   kernel once (counted by hooks on the modules over ``prepare`` and one
   step), and the profile holds exactly one device kernel of
   ``group_norm.cu`` for each such call (one launch a call; the phase's
   profiled launches a step are printed); every step call takes the
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
   C = 320-1280 LayerNorms with it): ``prepare`` and 4 frames at 512x512,
   profiled; every LayerNorm whose input meets the JAX conditions launches
   the kernel once (counted by hooks, which log its shapes); then the
   kernel is checked against its plain version at each of those shapes.
11. captured step, at the main path's configuration: 24 replays of the
   captured step on one state against the eager ``_frame_step`` on a twin
   state from the same seed (through window fill and eviction), bit for
   bit: every uint8 output, x_t_buffer, depth_buffer, the window tensors
   and every KV cache (data and scales); then the same with a bf16 cache
   at phase 5's configuration. The first call's time, the capture time and
   each stream's peak device memory net of the start; the captured and
   eager steps in turns for 30 rounds (frame p50, p90, rounds won) with
   each one's device time a step and share of the frame; ``stream_burst``
   of 10 frames against 10 replays, each way round, bit for bit (a second
   state's capture timed); ``PipelinedStream.map`` over 32 uint8 host
   frames (``max_in_flight=2``) against the synchronous loop, bit for bit,
   with its ``throughput_fps``; and three ``prepare()``-and-stream cycles
   that must leave device memory within one state's tensors of the first
   cycle, with at most one graph alive.
12. ingest and wrapper: phase 4's pipeline (random weights, seed 0) with
   the full-width CLIP text encoder, written in the real files' layouts
   (``unet/diffusion_pytorch_model.bin``, ``text_encoder/pytorch_model.bin``,
   a synthetic ``tokenizer/vocab.json`` and ``merges.txt``, a motion-module
   ``.ckpt`` with a ``state_dict`` wrapper, ``module.`` prefixes and a
   ``grid`` buffer, ``dpt_hybrid_384.pt``; TAESD, a kohya-style LoRA and a
   peft-style LCM-LoRA as ``.safetensors`` written by hand), then built by
   ``StreamV2VWrapper`` from a config naming them (CLIP, clip_skip 2, int8
   cache, ``output_type="np"``). Every ingested parameter equals the
   in-memory twin's, which carries the same LoRA merges; the CLIP
   embedding is within 0.05 relative RMS of fp32 on the CPU; ``prepare``
   (warmup, warm step, capture) launches the expected kernels, and 16
   ``img2img`` frames of 512x512 uint8 launch nothing more, capture
   nothing and equal the twin's bare ``stream()`` calls bit for bit, timed
   in turns; ``update_lora_scale`` (0.5 -> 1.25) keeps every parameter's
   address, and the replays that follow are within 0.05 relative RMS of a
   fresh build at 1.25 stepped from the same state; the float32-frame
   graph's device kernels a step equal phase 4's. Prints the ingest
   seconds (read, LoRA merge, load), the prompt-encode ms, the first
   ``img2img`` ms and the wrapper's frame p50 beside the bare ``stream()``
   p50.
13. KL codec: phase 4's configuration with ``use_tiny_vae=False`` (SD-1.5's
   AutoencoderKL, random weights from seed 0): first the narrow pipeline
   with the KL codec on the card (bf16) against fp32 on the CPU, as phase 3;
   then ``prepare`` and 16 frames at full width, profiled, with stream
   attention, flash and LayerNorm launched as in phase 4 and no TAESD conv
   kernel; the codec's encode (frame and depth image) and decode alone
   beside TAESD's, its share of the frame, peak memory, and 16 frames in
   turns with phase 4's pipeline.
14. MultiStream: phase 4's pipeline (TAESD, depth, int8 cache) at S = 2 and
   S = 4 sessions, both graphs captured when each ``MultiStream`` is built
   (its two eager warm rounds and two captures launch four single steps'
   worth of each kernel, asserted), ``prepare_session`` for each slot from
   its own seed; 16 all-active rounds in turns with phase 4's single
   stream, each session held to a single-session twin of the same seed
   and frames (noised latents within 0.05 relative RMS, uint8 outputs
   within 2 levels); 8 masked rounds with the
   last session idle, whose tensors and generator state are bit-equal
   across each; fed again it matches its twin (and, at S = 2, bit for bit
   a MultiStream session that never idled); a round's device kernels by
   name in a profile of replays equal one single-session step's. Prints
   the round p50 per S, the frames a second in all against the single
   stream's, the masked round's cost over the plain one's, peak memory.
15. demo server: ``serve/server.py``'s ``BatchedDemoPipeline`` with 2
   sessions at 512x512 (the server's default flags) on a free localhost
   port in this process; two WebSocket users send JPEG frames (8 warmup,
   then one at a time) until 16 MJPEG outputs each came back, decoded and
   shape-checked. Prints each user's fps and which encoder (framepump's
   libjpeg or Pillow) wrote the MJPEG frames.
16. training: motion-module training at the JAX trainer's full-width
   defaults (``UNetConfig()``, ``VAEConfig()``, 256x256, batch 2, clip 4,
   lr 1e-4, weight decay 0.01, fp32, random weights from seed 0, synthetic
   clips). First phase 3's narrow UNet with its depth branch: one loss and
   its backward on the card against fp32 on the CPU (same weights, clips,
   t and noise; the loss and the motion gradients within 1e-3 relative
   RMS). Then ``Trainer`` on the card: one step logs every shape the
   attention is given; 20 more steps are counted (72 forward and 70
   backward launches of the fp32 training kernels a step, no other hand
   kernel) and timed (step p50 / p90 on the host clock, synchronised,
   clips a second, peak memory), 3 profiled (device ms a step, the device
   share, the attention kernels' share, the device kernels by name); every
   loss finite, every frozen parameter and the VAE bit-equal, every motion
   parameter moved; a save, a resume into a fresh ``Trainer`` (the state
   restored bit for bit) and 2 more steps in both (losses within 1e-5).
   Then both training kernels against their plain versions at every shape
   the step logged (O and lse, dq, dk and dv within 1e-4 of the plain
   version's largest value), with their times, the plain versions', SDPA's
   forward and backward in fp32 (a yardstick the port never calls) and the
   bound (bytes; 4 N H Sq Sk D operations of products forward and 10
   backward, each as 3 TF32 products at 495 TFLOP/s, the least time for
   fp32-accurate products on the tensor cores, with the time at 67 TFLOP/s
   of the fp32 lanes beside it; the exponentials, twice in the backward).
   Each row names its route (``ops/flash_train.py:train_route``); the
   counted steps' launches are asserted by route, and the profile's device
   kernels by route (the short route's one kernel a launch, the tiled
   backward's two). Prints the TF32 settings in force.
17. warm start and the tools (run between phases 14 and 15, the last to
   use phase 4's stream, so that phases 15 and 16 run with it freed, as
   they did before this phase was added): the port's package is copied into a
   temporary directory (its build directory, beside the copy, starts
   empty); a cold process imports the copy, builds the bench-default
   ``StreamV2VWrapper`` (512x512, TAESD, DPT-hybrid, int8 cache), prepares
   it on 8 frames, streams one frame (nvcc builds each library at its
   first launch) and primes an engine directory (``prime_aot``); a warm
   process empties the copy's build directory and does the same from that
   engine directory. Asserted: the manifest lists exactly the libraries
   the cold frame built; the warm start hit
   (``aot_hit``), ran no build and left the build directory empty, and
   every main-path kernel launched; its first frame is bit-equal to the
   cold one; a copy of the directory with one flipped byte in a library is
   refused (its sha256) and left as it was. Prints each start's build,
   load, prepare and first-step seconds, the seconds from process start to
   the first frame and the seconds in ``_build.build``. Then the tools on
   phase 4's stream: ``trace_step`` over 8 synchronised replays (each
   kernel in the frame whose runtime call launched it, by correlation id;
   the step's kernels, each name as often as the fullest frame holds it,
   must equal phase 4's profile (a frame short of some lost them in the
   trace, and they are printed by name), no record may lie outside the
   frames, and the device ms a frame must be within 3 % of phase 4's; prints the top kernels, families, buckets, the frame's split
   into host time before the replay, the replay's host time, device busy
   time and idle time inside the device span of the replay, and host time
   around it, and the gaps between kernels by width),
   ``profile_stages`` (each stage captured alone beside the step), and
   ``parity`` at ``--tiny`` on the card against its own output (inf).
18. tensor and data parallelism (after phase 16), the JAX package's
   multi-chip path (``live2diff_tpu/parallel/``, ``__graft_entry__.
   dryrun_multichip``) on ``parallel/{mesh,tp,infer}.py``. The card is one,
   and NCCL refuses two ranks on one device, so two ranks share it over
   gloo, which takes CUDA tensors in ``all_reduce`` and ``broadcast``; NCCL
   runs the same helpers across cards. (a) In this process: #1 (int8 and
   bf16 cache) and #3 (d-major, and the fp32 training pair forward and
   backward) against their plain versions at every shape one tp rank of
   tp = 2, 4 and 8 gives the full-width UNet (motion C/tp channels of 8/tp
   heads, spatial 8/tp heads at 512x512, phase 16's training shapes at
   8/tp heads), each beside its tp = 1 row, with its route and cluster.
   Then two ranks (``chip_smoke.py --tp-rank``), each: (b) ``UNetConfig()``
   at 512x512, 2 steps, bf16, int8 cache, random weights from seed 0, the
   warmup on 8 frames then 8 stream frames, eager (a step with gloo
   collectives cannot be captured in a CUDA graph), unsharded and then at
   tp = 2 on the same inputs: every frame within 1e-2 relative RMS, the
   cache slabs printed (the share of int8 codes that differ, by at most
   one), at least 60 % of the parameter bytes on tp, 40 #1 and 32 #3
   launches a rank's step and no other kernel; (c) the train step at
   phase 16's widths (256x256, batch 2, clip 4, fp32, TF32 off, every
   weight drawn) at tp = 2 against an unsharded twin in the same process,
   3 steps: the loss within 1e-5, every motion gradient within 1e-4 of its
   largest element, the replicated motion parameters bit-equal across the
   tp ranks after each step, the step ms and peak memory printed (both
   ranks share the card: not a speed figure); (d) 4 sessions of phase 14's
   pipeline without depth over dp = 2, each rank's ``MultiStream`` of 2,
   against one ``MultiStream`` of 4 here (uint8 outputs within 2 levels,
   noised latents within 0.05 relative RMS); then ``dryrun_multichip``.
   Prints the phase's seconds.
19. the port bench (after phase 18): ``python -m live2diff_tpu_torch.bench
   --frames 40 --budget 300`` in a process of its own, from an empty engine
   directory, which it primes: its last JSON line is printed, and the phase
   fails if it has no headline, if a row was skipped or reports ``None`` or
   ``"error"``, or if ``kernel_selftest`` is not ``"pass"``; then a second
   run (``--frames 10 --budget 0``) from the directory the first primed,
   which must load from it (``aot_hit``). Each run's step must launch the
   hand kernels phase 4's does, as often (counted at its capture, printed on
   a stage line). The bench's frame numbers are printed beside phase 4's
   frame p50. Then bench.py's pipeline at full width with
   ``param_dtype=torch.float32`` (bf16 compute) against a twin holding the
   same weights rounded to bf16: ``prepare`` and 20 captured frames each
   from the same inputs, every uint8 output and the latents each step
   leaves within their limits (``PARAM_DTYPE_RMS_TOL``,
   ``PARAM_DTYPE_LATENT_TOL``, relative RMS) of the twin's, the same
   hand-kernel launches a step, the twin's kernels a step within 7,265 (the
   profile); prints each one's relative RMS, kernels and device ms a step,
   parameter bytes and peak memory. Last, the control: the fp32-parameter
   pipeline with one UNet GroupNorm bias dropped, 20 frames again, whose
   latents must cross their limit.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or run from a
directory that does not hold the port, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import time
from collections import Counter, defaultdict

MEM_BW = 3.35e12  # H100 SXM HBM3, bytes/s
# dense tensor-core bf16, int8 and TF32; fp32 outside tensor cores
PEAK = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "fp32": 67e12}
# exponentials: 16 a clock per SM (compute capability 9.0), times the SMs
# and the card's max SM clock, both read in main()
SFU_PER_SM_CLOCK = 16
SFU_RATE = []  # [exp / s], set once the card is known
# kernel launches a main-path stream step in the profile, measured before
# the int8 KV cache divided by a tensor: that division must not add any
MAIN_PATH_LAUNCHES_PER_STEP = 7265
# stream-attention launches a main-path step by route (132 SMs)
MAIN_PATH_ROUTES = {"tma": 40, "scalar": 0, "cluster": 30}

# the device kernels of each wrapper launch in the profile, by patterns of
# the profiler's kernel names: one of each a launch (the int8-QK flash entry
# launches its pre-pass and the flash core). The training wrappers' kernels
# are listed by route ("<wrapper>:<route>"; by_device_kernels)
DEVICE_KERNELS = {
    "stream_attention_int8": (r"stream_attention_kernel<signed char,",),
    "stream_attention_bf16": (r"stream_attention_kernel<__nv_bfloat16,",),
    "flash_attention": (r"flash_sm90_kernel<\d+, false, false>",),
    "flash_attention_smajor": (r"flash_sm90_kernel<\d+, true, false>",),
    "flash_attention_int8": (r"flash_sm90_kernel<\d+, true, true>", r"quantise_kernel\("),
    "conv3x3": (r"conv3x3_sm90<1, ",),
    "conv3x3_s2": (r"conv3x3_sm90<2, ",),
    "layer_norm": (r"layer_norm_kernel<",),
    "group_norm": (r"group_norm_kernel<",),
    "flash_train_fwd:short": (r"flash_train_short_fwd_kernel<",),
    "flash_train_fwd:tiled": (r"flash_train_tiled_fwd(_split)?_kernel<",),
    "flash_train_bwd:short": (r"flash_train_short_bwd_kernel<",),
    "flash_train_bwd:tiled": (r"flash_train_tiled_dq_kernel<", r"flash_train_tiled_dkdv_kernel<"),
}
TRAIN_WRAPPERS = ("flash_train_fwd", "flash_train_bwd")
TRAIN_ROUTES = ("short", "tiled")


def by_device_kernels(expected, routes=None):
    """``expected`` (launches by wrapper) keyed as ``DEVICE_KERNELS`` is: a
    training wrapper's launches split by route as ``routes`` gives them
    ({"<wrapper>:<route>": n}, which must sum to the wrapper's count);
    without ``routes``, a training wrapper must launch nothing."""
    out = {}
    for name, n in expected.items():
        if name not in TRAIN_WRAPPERS:
            out[name] = n
            continue
        split = {f"{name}:{r}": (routes or {}).get(f"{name}:{r}", 0) for r in TRAIN_ROUTES}
        if sum(split.values()) != n:
            raise AssertionError(f"{name}: {n} launches expected, by route {split}")
        out.update(split)
    return out

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
OPT_IN_OFF = {"flash_attention_smajor": 0, "flash_attention_int8": 0, "group_norm": 0,
              # nor the training kernels, on any path but phase 16's
              "flash_train_fwd": 0, "flash_train_bwd": 0}
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


# (C, HW, calls per 512x512 step, calls per 768x512 step): the 4 UNet levels
# of each row, 10 stream-attention calls each per stream step
STREAM_LEVELS = ((320, 4096, 10, 0), (640, 1024, 10, 0), (1280, 256, 10, 0), (1280, 64, 10, 0),
                 (320, 6144, 0, 10), (640, 1536, 0, 10), (1280, 384, 0, 10), (1280, 96, 0, 10))


def check_stream_attention(torch, gen, dev, cache: str, tp: int = 1):
    """The stream-attention kernel against its plain version at the stream
    steps' shapes; at ``tp`` > 1 at one tp rank's shapes of the 512x512
    step (C/tp channels of 8/tp heads)."""
    from live2diff_tpu_torch.ops.stream_attention import (
        plan, stream_window_attention_bf16, stream_window_attention_int8,
        stream_window_attention_plain,
    )

    s, heads, window = 2, 8 // tp, 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    levels = STREAM_LEVELS if tp == 1 else [(c // tp, hw, calls, 0)
                                            for c, hw, calls, _ in STREAM_LEVELS if calls]
    for c, hw, calls, calls_wide in levels:
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
            shape=f"q[{s},{hw},{c}] cache[{s},2,{window},{c},{hw}] {cache}"
                  + (f" heads {heads} (tp {tp})" if tp > 1 else ""), calls=calls, tp=tp,
            calls_768x512=calls_wide, prepare_calls=0, max_abs_err=err, rel_err=rel, tol=2e-2,
            route=f"{staging}, cluster {cluster}", ms=ms,
            plain_ms=time_ms(lambda: stream_window_attention_plain(*plain_args), 3),
            bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms, library_ms=None,
        ))
        del data, out, ref
    return rows


# (B, Sq, Sk, H, D, calls per stream step, calls per 768x512 step, calls in
# prepare). The stream step: self- and cross-attention (77 text tokens) of
# the 2-step batch at the 4 levels (the UNet's 32), and the DPT's ViT
# self-attention over 577 tokens, 12 heads, in each of its 12 blocks.
# prepare(): spatial attention over the 8 warmup frames (B = 8), the
# bidirectional motion attention over those 8 frames with the positions
# folded into the batch (B = HW, S = 8), and the ViT over the 8 warmup
# frames. The 768x512 step: the same at that row's levels (S = 6144, 1536,
# 384, 96) and the ViT, whose input is 384x384 at either size
FLASH_SHAPES = (
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
)


def check_flash(torch, gen, dev, tp: int = 1):
    """The d-major flash kernel against its plain version at the stream
    steps' and prepare's shapes; at ``tp`` > 1 at one tp rank's shapes of
    the UNet's 512x512 step (8/tp heads; the ViT is not cut)."""
    import torch.nn.functional as F

    from live2diff_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    rows = []
    shapes = FLASH_SHAPES if tp == 1 else [
        (b, sq, sk, h // tp, d, calls, 0, 0)
        for b, sq, sk, h, d, calls, _, _ in FLASH_SHAPES if calls and h == 8]
    for b, sq, sk, h, d, calls, calls_wide, prep in shapes:
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
            shape=f"q[{b},{sq},{h},{d}] k[{b},{sk},{h},{d}]", calls=calls, tp=tp,
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


def small_input_check(torch, use_tiny_vae: bool = True):
    from live2diff_tpu_torch.builder import build_pipeline
    from live2diff_tpu_torch.models.midas import DPTConfig, DPTDepthModel
    from live2diff_tpu_torch.stream.pipeline import StreamDiffusionDepth

    gen = torch.Generator().manual_seed(5)
    dpt = DPTDepthModel(DPTConfig(**SMALL_DPT))
    fan_in_init_(dpt, gen)

    def build(device, dtype):
        b = build_pipeline(SMALL_CONFIG, 64, 64, dtype=dtype, kv_cache_dtype="int8",
                           seed=0, device=device, unet_overrides=SMALL_UNET, use_depth=False,
                           use_tiny_vae=use_tiny_vae)
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


def run_stream(torch, _build, n_frames, expected_step, expected_prepare,
               height=512, width=512, record_gn=False, record_ln=False, keep=None,
               **build_kw):
    """build_pipeline at full width, prepare, then ``n_frames`` frames, each
    timed on the host clock to a synchronize. The first frame captures the
    step in a CUDA graph; every frame replays it. Launch counts are zeroed
    just before prepare and before the frames, and asserted just after
    prepare and after the first frame (the capture: one step), and again
    after the last (replays launch nothing through the wrappers); then the
    device kernels of each wrapper are asserted per step in the profile of
    a few replays. With ``record_gn`` (``record_ln``) the GroupNorm
    (LayerNorm) calls that meet the kernel conditions are logged over
    prepare and the (untimed) warm step, and ``group_norm``
    (``layer_norm``) is expected to launch once for each of them. ``keep``,
    a list, gets the stream, its state and the frames, for ``interleaved``."""
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
    # the warm step runs on a throwaway state (a second set of KV caches),
    # eagerly, before the first capture
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
        if i == 0:
            captured = dict(_build.launch_counts)
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
    # (a) the wrappers' counts over the capture are one step's; the replays
    # add none
    check_counts("the capture of the stream step", captured, expected_step, 1)
    if counts != captured:
        raise AssertionError(f"{n_frames - 1} replays launched through the wrappers: "
                             f"{counts} after them, {captured} after the capture")
    if not torch.isfinite(state.depth_buffer).all():
        raise AssertionError("non-finite depth latents")
    steady = sorted(times[2:])
    result = dict(
        frame=f"{width}x{height}", params=n_params, build_s=build_s, prepare_s=prepare_s,
        first_step_s=first_step_s, frames=n_frames,
        # the first call captures the step, then replays it
        first_call_ms=times[0], capture_ms=stream._graphs.find(state, torch.uint8).capture_s * 1e3,
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
        launches_per_step=captured,
        stream_attention_routes_per_step=routes,
        group_norm_routes_per_step=gn_routes,
    )
    if record_gn:
        result["group_norm_shapes"] = (logged_step["group_norm"], logged_prepare["group_norm"])
    if record_ln:
        result["layer_norm_sites"] = (logged_step["layer_norm"], logged_prepare["layer_norm"])
    if built.depth_model is not None:
        result["raw_depth"] = raw_depth_stats(torch, stream, frames[:4])
    if keep is not None:
        keep.append((stream, state, frames))
    result["profile"] = prof = profile_steps(torch, stream, state, frames[:4])
    if isinstance(prof["device_ms_per_call"], float):
        # the profiler slows the host; the busy share of an unprofiled step
        prof["device_ms_over_frame_ms_p50"] = prof["device_ms_per_call"] / result["frame_ms_p50"]
    # (b) each wrapper's device kernels in the profiled replays, per step
    result["device_kernels_per_step"] = check_device_kernels(
        f"{width}x{height} replays", prof, expected_step,
        lambda: profile_steps(torch, stream, state, frames[:4]))
    if built.depth_model is not None:
        result["depth_profile"] = dprof = profile_depth(torch, stream, frames[:4])
        if isinstance(dprof["device_ms_per_call"], float):
            dprof["share_of_step_device_ms"] = (dprof["device_ms_per_call"]
                                                / prof["device_ms_per_call"])
            dprof["share_of_step_kernels"] = (dprof["kernels_per_call"]
                                              / prof["kernels_per_call"])
    return result, captured


def interleaved(torch, runs, rounds, after=None):
    """Frame times of several pipelines streamed in turn, one frame each a
    round, the order rotated every round, so that the host's drift over the
    run falls on all of them alike. ``runs``: {name: (stream, state,
    frames)}. Returns {name: {p50, p90, wins}}, ``wins`` counting the rounds
    in which that pipeline's frame was the fastest; ``after``, a dict, gets
    the states they leave by name."""
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
    if after is not None:
        after.update(states)
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
    launches per call by kernel name, the device kernels per call of each
    wrapper (``DEVICE_KERNELS``), and the device-busy share of the wall time
    (which the profiler's own host overhead lowers). Kernels replayed from a
    CUDA graph are recorded one by one."""
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
        # a range annotated on the host (the optimizer's step) is also
        # recorded on the device around the kernels it launched: not a kernel
        if getattr(e, "is_user_annotation", False) or e.key.startswith("Optimizer."):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / n, e.count / n, e.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    by_wrapper = {name: [sum(r[1] for r in rows if re.search(pat, r[2])) for pat in pats]
                  for name, pats in DEVICE_KERNELS.items()}
    ms_by_wrapper = {name: [sum(r[0] for r in rows if re.search(pat, r[2])) for pat in pats]
                     for name, pats in DEVICE_KERNELS.items()}
    return dict(
        calls=n, wall_ms_per_call=wall_ms,
        device_ms_per_call=device_ms if rows else "not measured",
        kernels_per_call=sum(r[1] for r in rows) if rows else "not measured",
        device_kernels_per_call=by_wrapper, device_ms_by_wrapper=ms_by_wrapper,
        device_busy_share=device_ms / wall_ms if rows else "not measured",
        top=[dict(ms_per_call=r[0], launches_per_call=r[1], name=r[2][:90]) for r in rows[:25]],
    )


def check_device_kernels(what, prof, expected, retrace, tries: int = 3, routes=None):
    """Each wrapper's device kernels per step in a profile of replays (every
    name ``DEVICE_KERNELS`` lists for it) against ``expected``, its
    launches a step (the training wrappers' split by ``routes``, see
    ``by_device_kernels``). Late in a long run the profiler drops a few
    records of a trace (PERF.md); a trace that holds fewer of some kernel
    and more of none is taken again by ``retrace()``, up to ``tries`` traces
    in all. Returns the counts of the trace that matched, keyed as
    ``DEVICE_KERNELS``; raises if none did."""
    expected = by_device_kernels(expected, routes)
    seen = []
    while True:
        got = prof["device_kernels_per_call"]
        seen.append(got)
        diff = {name: (got[name], n) for name, n in expected.items()
                if any(c != n for c in got[name])}
        if not diff:
            return {name: got[name][0] for name in expected}
        over = any(c > n for name, n in expected.items() for c in got[name])
        if over or len(seen) == tries:
            raise AssertionError(f"{what}: device kernels a step (seen, expected) {diff} "
                                 f"in trace {len(seen)} of {tries}")
        prof = retrace()


def profile_steps(torch, stream, state, frames, after=None):
    """The device profile of a few stream steps; ``after``, a list, gets the
    state they leave."""
    box, it = [state], iter(frames)

    def step():
        box[0], _ = stream(box[0], next(it))

    prof = profile_device(torch, step, len(frames))
    if after is not None:
        after.append(box[0])
    return prof


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
        if "bound_fp32_lanes_ms" in r:
            extra += f" fp32-lane bound {r['bound_fp32_lanes_ms']:.4f}"
        if "device_ms" in r:
            extra += f" device ms {r['device_ms']} (share of bound {r['device_bound_share']})"
        print(f"{k['name']:22s} {r['shape']:48s} rel {r['rel_err']:.2e} (tol {r['tol']}){extra} "
              f"ms {r['ms']:.4f} plain {r['plain_ms']:.3f} bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}) library {r['library_ms']}")
    totals = [(k.get("per_what", "stream step"), k)] + [
        (what, k[total]) for total, (_, what) in OTHER_STEPS.items() if total in k]
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


# ---------------------------------------------------------------------------
# phase 11: the captured step against the eager one
# ---------------------------------------------------------------------------

CAPTURE_FRAMES = 24  # through window fill and eviction (window 16, sink 8)
BURST_FRAMES = 10
CLIENT_FRAMES = 32
RELEASE_CYCLES = 3


def eager_step(stream):
    """The eager step of ``stream`` as a ``(state, frame) -> (state, out)``
    callable: ``_frame_step`` with the stream's prompt, no graph."""
    return lambda state, frame: stream._frame_step(state, frame, stream._prompt_embeds)


def twin_states(torch, n_frames, **build_kw):
    """build_pipeline at 512x512 and two states prepared from the same seed,
    warm frames and prompt; returns the stream, both states, the inputs
    (``frames`` on the device) and the bytes of one state's tensors."""
    from live2diff_tpu_torch.builder import build_pipeline
    from live2diff_tpu_torch.stream.graph import state_tensors

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    stream = build_pipeline(BENCH_CONFIG, 512, 512, dtype=torch.bfloat16, output_uint8=True,
                            seed=0, device=dev, **build_kw).stream
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = dict(prompt=torch.randn(1, 77, 768, generator=gen, device=dev),
                  warm=torch.rand(8, 512, 512, 3, generator=gen, device=dev) * 2 - 1,
                  frames=torch.randint(0, 256, (n_frames, 512, 512, 3), generator=gen,
                                       device=dev, dtype=torch.uint8))
    a, _ = stream.prepare(inputs["warm"], inputs["prompt"], seed=2)
    b, _ = stream.prepare(inputs["warm"], inputs["prompt"], seed=2)
    state_bytes = sum(t.numel() * t.element_size() for t in state_tensors(a))
    return stream, a, b, inputs, state_bytes


def assert_twins(torch, what, a, b):
    """Every tensor of two states equal bit for bit: x_t_buffer,
    depth_buffer, the window tensors and every KV cache (data and scales)."""
    from live2diff_tpu_torch.stream.graph import state_tensors

    differ = [i for i, (x, y) in enumerate(zip(state_tensors(a), state_tensors(b)))
              if not torch.equal(x, y)]
    if differ or a.frame_idx != b.frame_idx:
        raise AssertionError(f"{what}: state tensors {differ} (of {len(state_tensors(a))}) "
                             f"differ, frame_idx {a.frame_idx} / {b.frame_idx}")


def assert_equal_outputs(torch, what, ours, ref):
    differ = {i: (a.int() - b.int()).abs().max().item()
              for i, (a, b) in enumerate(zip(ours, ref)) if not torch.equal(a, b)}
    if differ or len(ours) != len(ref):
        raise AssertionError(f"{what}: outputs differ (frame: max |d| uint8) {differ}")


def captured_step_equality(torch, keep=None, **build_kw):
    """``CAPTURE_FRAMES`` replays of the captured step on one state against
    ``_frame_step`` on a twin, bit for bit: each uint8 output, then the
    states. Also the first call's time (capture and one replay) and each
    stream's peak device memory over its frames, net of the start.
    ``keep``, a dict, gets the stream, both states and the inputs."""
    stream, state_g, state_e, inputs, state_bytes = twin_states(
        torch, CAPTURE_FRAMES, **build_kw)
    frames = inputs["frames"]
    stream.warm_frame_step(torch.uint8)
    memory = {}

    def run(name, step, state):
        torch.cuda.synchronize()
        start, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        outs, t0 = [], time.perf_counter()
        for i, frame in enumerate(frames):
            state, out = step(state, frame)
            outs.append(out)
            if i == 0:
                torch.cuda.synchronize()
                first_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        memory[name] = dict(peak_net_bytes=torch.cuda.max_memory_allocated() - start,
                            reserved_growth_bytes=torch.cuda.memory_reserved() - reserved)
        return state, outs, first_ms

    state_g, outs_g, first_call_ms = run("captured", stream, state_g)
    state_e, outs_e, _ = run("eager", eager_step(stream), state_e)
    assert_equal_outputs(torch, f"{CAPTURE_FRAMES} replays against the eager step", outs_g, outs_e)
    assert_twins(torch, f"after {CAPTURE_FRAMES} replays and eager steps", state_g, state_e)
    if keep is not None:
        keep.update(stream=stream, state_g=state_g, state_e=state_e, inputs=inputs,
                    state_bytes=state_bytes)
    return dict(frames=CAPTURE_FRAMES, outputs_bit_equal=True, states_bit_equal=True,
                first_call_ms=first_call_ms,
                capture_ms=stream._graphs.find(state_g, torch.uint8).capture_s * 1e3,
                memory=memory, state_bytes=state_bytes)


def captured_step_phase(torch, _build):
    """Phase 11 at the main path's configuration: equality, interleaved
    frame times and device shares, stream_burst, PipelinedStream.map, and
    the release of dropped states' graphs over prepare() cycles."""
    import numpy as np

    from live2diff_tpu_torch.stream.client import PipelinedStream

    kept = {}
    result = captured_step_equality(torch, keep=kept, kv_cache_dtype="int8")
    stream, state_g, state_e = kept["stream"], kept["state_g"], kept["state_e"]
    frames = kept["inputs"]["frames"]
    eager = eager_step(stream)

    # frame times in turns, then each step's device time a frame; both
    # states take the same frames, so they stay twins
    states = {}
    result["interleaved"] = ab = interleaved(
        torch, {"captured": (stream, state_g, frames), "eager": (eager, state_e, frames)},
        INTERLEAVED_ROUNDS, after=states)
    after = []
    for name, step in (("captured", stream), ("eager", eager)):
        prof = profile_steps(torch, step, states[name], frames[:4], after=after)
        ab[name].update(device_ms_per_step=prof["device_ms_per_call"],
                        kernels_per_step=prof["kernels_per_call"],
                        device_share_of_frame_p50=prof["device_ms_per_call"]
                        / ab[name]["frame_ms_p50"])
    state_g, state_e = after
    assert_twins(torch, "after the interleaved and profiled frames", state_g, state_e)

    # stream_burst against replays, each way round; the first replays of
    # state_e capture its own graph
    def burst(state, chunk):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, outs = stream.stream_burst(state, chunk)
        torch.cuda.synchronize()
        return state, outs, (time.perf_counter() - t0) * 1e3 / len(chunk)

    def calls(state, chunk):
        torch.cuda.synchronize()
        outs, t0 = [], time.perf_counter()
        for f in chunk:
            state, out = stream(state, f)
            outs.append(out)
        torch.cuda.synchronize()
        return state, outs, (time.perf_counter() - t0) * 1e3 / len(chunk)

    first, second = frames[:BURST_FRAMES], frames[BURST_FRAMES:2 * BURST_FRAMES]
    state_g, burst_a, burst_ms_a = burst(state_g, first)
    t0 = time.perf_counter()
    state_e, out = stream(state_e, first[0])
    torch.cuda.synchronize()
    second_capture_ms = (time.perf_counter() - t0) * 1e3
    state_e, outs_a, _ = calls(state_e, first[1:])
    assert_equal_outputs(torch, "stream_burst against replays", list(burst_a), [out] + outs_a)
    state_e, burst_b, burst_ms_b = burst(state_e, second)
    state_g, outs_b, calls_ms = calls(state_g, second)
    assert_equal_outputs(torch, "stream_burst against replays (second state)", list(burst_b),
                         outs_b)
    assert_twins(torch, "after the bursts", state_g, state_e)
    result["stream_burst"] = dict(
        frames=BURST_FRAMES, bit_equal_to_replays=True, ms_a_frame=[burst_ms_a, burst_ms_b],
        replays_ms_a_frame=calls_ms, second_state_first_call_ms=second_capture_ms,
        second_state_capture_ms=stream._graphs.find(state_e, torch.uint8).capture_s * 1e3)
    del burst_a, burst_b, outs_a, outs_b, out

    # PipelinedStream.map over host frames against the synchronous loop
    host = torch.randint(0, 256, (CLIENT_FRAMES, 512, 512, 3),
                         generator=torch.Generator().manual_seed(3), dtype=torch.uint8).numpy()
    ps = PipelinedStream(stream, state_g, max_in_flight=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    piped = list(ps.map(iter(list(host))))
    torch.cuda.synchronize()
    map_ms = (time.perf_counter() - t0) * 1e3 / CLIENT_FRAMES
    state_g = ps.state
    sync, sync_ms = [], []
    for f in host:
        t0 = time.perf_counter()
        state_e, out = stream(state_e, f)
        torch.cuda.synchronize()
        sync_ms.append((time.perf_counter() - t0) * 1e3)
        sync.append(out)
    assert_equal_outputs(torch, "PipelinedStream.map against the synchronous loop", piped, sync)
    assert_twins(torch, "after PipelinedStream.map", state_g, state_e)
    result["pipelined_stream"] = dict(
        frames=CLIENT_FRAMES, max_in_flight=2, bit_equal_to_sync_loop=True,
        throughput_fps=ps.throughput_fps(), wall_ms_a_frame=map_ms,
        sync_loop_ms_p50=statistics.median(sync_ms), sync_loop_fps=1e3 / np.mean(sync_ms))
    del ps, piped, sync, out

    # dropped states and new prepare() cycles: the graphs of dropped states
    # go, and with them their caches and activations
    state_bytes, inputs = kept["state_bytes"], kept["inputs"]
    del state_g, state_e, kept, states, after
    cycles = []
    for _ in range(RELEASE_CYCLES):
        state, _ = stream.prepare(inputs["warm"], inputs["prompt"], seed=2)
        for f in frames[:4]:
            state, _ = stream(state, f)
        del state
        gc.collect()
        torch.cuda.synchronize()
        cycles.append(dict(allocated_bytes=torch.cuda.memory_allocated(),
                           reserved_bytes=torch.cuda.memory_reserved(),
                           graphs=len(stream._graphs.graphs)))
    growth = cycles[-1]["allocated_bytes"] - cycles[0]["allocated_bytes"]
    result["release"] = dict(cycles=cycles, allocated_growth_bytes=growth,
                             limit_bytes=state_bytes)
    if growth > state_bytes or max(c["graphs"] for c in cycles) > 1:
        raise AssertionError(f"release: {RELEASE_CYCLES} prepare() cycles: {cycles}, "
                             f"allocated grew {growth} bytes (one state: {state_bytes})")
    return result


# ---------------------------------------------------------------------------
# phase 12: checkpoint ingest and the wrapper at full width
# ---------------------------------------------------------------------------

WRAPPER_FRAMES = 16
LORA_RANK = 4
STYLE_ALPHA, STYLE_NEW_ALPHA = 0.5, 1.25
WRAPPER_SEED = 42
WRAPPER_PROMPT = "a cat in the rain"
WRAPPER_TEMPLATE = "masterpiece, best quality, intricate, print, pattern, {}"
CLIP_SKIP = 2  # the style configs' third_party_dict.clip_skip
# the CLIP embedding on the card (bf16) against fp32 on the CPU
CLIP_RMS_TOL = 0.05
# replays after update_lora_scale against a fresh build at the new strength:
# the two round the same merged weights to bf16 along two paths (<= 1.5 ulp)
LORA_RMS_TOL = 0.05
UPDATE_FRAMES = 4


def write_safetensors(torch, path, tensors) -> None:
    """A ``.safetensors`` file by hand (the format: an 8-byte little-endian
    header length, a JSON header, the raw bytes), as the LoRA and TAESD
    files ship; no safetensors package is needed."""
    names = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16"}
    header, blobs, offset = {}, [], 0
    for k, t in tensors.items():
        b = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[k] = {"dtype": names[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + len(b)]}
        blobs.append(b)
        offset += len(b)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for b in blobs:
            f.write(b)


def write_vocab(root, words) -> None:
    """A synthetic ``tokenizer/vocab.json`` and ``merges.txt``: CLIP's byte
    alphabet (with and without ``</w>``) plus the merges that build
    ``words``."""
    from live2diff_tpu_torch.utils.tokenizer import bytes_to_unicode

    chars = list(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars + [c + "</w>" for c in chars])}
    merges = []
    for word in words:
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            if (parts[0], parts[1]) not in merges:
                merges.append((parts[0], parts[1]))
            parts = [parts[0] + parts[1]] + parts[2:]
            vocab.setdefault(parts[0], len(vocab))
    for special in ("<|startoftext|>", "<|endoftext|>"):
        vocab[special] = len(vocab)
    os.makedirs(os.path.join(root, "tokenizer"))
    with open(os.path.join(root, "tokenizer", "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(os.path.join(root, "tokenizer", "merges.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(["#version: 0.2"] + [f"{a} {b}" for a, b in merges]) + "\n")


def lora_factors(torch, gen, out_dim, in_shape):
    """Rank-4 (up, down) factors, N(0, 0.05^2): a visible change on
    N(0, 0.02^2) weights."""
    up_shape = (out_dim, LORA_RANK) + ((1, 1) if len(in_shape) == 3 else ())
    up = torch.randn(up_shape, generator=gen) * 0.05
    down = torch.randn((LORA_RANK, *in_shape), generator=gen) * 0.05
    return up, down


def write_pipeline_files(torch, root, twin):
    """The weights of ``twin`` (a random full-width pipeline with a text
    encoder) in the real files' layouts, and a kohya-style style LoRA and a
    peft-style LCM-LoRA. Returns (config, LoRA state dicts, seconds)."""
    t0 = time.perf_counter()
    base = os.path.join(root, "sd15")
    unet_sd = {k: v.cpu() for k, v in twin.unet.state_dict().items()}
    text_sd = {k: v.cpu() for k, v in twin.text_encoder.state_dict().items()}
    os.makedirs(os.path.join(base, "unet"))
    torch.save({k: v for k, v in unet_sd.items() if ".motion_modules." not in k},
               os.path.join(base, "unet", "diffusion_pytorch_model.bin"))
    os.makedirs(os.path.join(base, "text_encoder"))
    torch.save(text_sd, os.path.join(base, "text_encoder", "pytorch_model.bin"))
    write_vocab(base, [w.strip(",") for w in (WRAPPER_TEMPLATE + " " + WRAPPER_PROMPT).split()
                       if w != "{}"])
    motion = {f"module.{k}": v for k, v in unet_sd.items() if ".motion_modules." in k}
    for k in [k for k in motion if k.endswith("attention_blocks.0.to_q.weight")]:
        motion[k[: -len("to_q.weight")] + "pos_encoder.pe"] = torch.zeros(1, 24, 320)
    motion["module.down_blocks.0.motion_modules.0.grid"] = torch.zeros(2, 64, 64)
    paths = {"motion": os.path.join(root, "live2diff.ckpt"),
             "dpt": os.path.join(root, "dpt_hybrid_384.pt"),
             "taesd": os.path.join(root, "taesd.safetensors"),
             "style": os.path.join(root, "style-lora.safetensors"),
             "lcm": os.path.join(root, "lcm-lora-sdv1-5.safetensors")}
    torch.save({"state_dict": motion, "global_step": 1}, paths["motion"])
    torch.save({k: v.cpu() for k, v in twin.depth_model.state_dict().items()}, paths["dpt"])
    write_safetensors(torch, paths["taesd"], twin.vae.state_dict())

    gen = torch.Generator().manual_seed(12)
    style, lcm = {}, {}
    targets = [k for k in unet_sd if k.endswith("attn2.to_k.weight")] + ["conv_in.weight"]
    for key in targets:
        w = unet_sd[key]
        up, down = lora_factors(torch, gen, w.shape[0], tuple(w.shape[1:]))
        name = "lora_unet_" + key[: -len(".weight")].replace(".", "_")
        style.update({f"{name}.lora_up.weight": up, f"{name}.lora_down.weight": down,
                      f"{name}.alpha": torch.tensor(float(LORA_RANK))})
    for i in range(twin.text_encoder.config.num_layers):
        key = f"text_model.encoder.layers.{i}.self_attn.q_proj.weight"
        up, down = lora_factors(torch, gen, text_sd[key].shape[0], (text_sd[key].shape[1],))
        name = "lora_te_" + key[: -len(".weight")].replace(".", "_")
        style.update({f"{name}.lora_up.weight": up, f"{name}.lora_down.weight": down})
    for key in [k for k in unet_sd if k.endswith("attn1.to_q.weight")]:
        w = unet_sd[key]
        up, down = lora_factors(torch, gen, w.shape[0], (w.shape[1],))
        name = "unet." + key[: -len(".weight")]
        lcm.update({f"{name}.lora_B.weight": up, f"{name}.lora_A.weight": down})
    write_safetensors(torch, paths["style"], style)
    write_safetensors(torch, paths["lcm"], lcm)
    config = dict(BENCH_CONFIG, pretrained_model_path=base, motion_module_path=paths["motion"],
                  depth_model_path=paths["dpt"], taesd_path=paths["taesd"],
                  lcm_lora_path=paths["lcm"], prompt_template=WRAPPER_TEMPLATE,
                  third_party_dict={"clip_skip": CLIP_SKIP, "lora_list": [
                      {"lora": paths["style"], "lora_alpha": STYLE_ALPHA}]})
    n_style = len(targets) + twin.text_encoder.config.num_layers
    return config, (unet_sd, text_sd, style, lcm, n_style), time.perf_counter() - t0


def merge_into_twin(torch, twin, unet_sd, text_sd, style, lcm):
    """The in-memory twin's weights: the same merges as the build (the
    style LoRA, then the LCM-LoRA), written into its modules in place."""
    from live2diff_tpu_torch.convert.lora import merge_lora_into_state_dict

    merge_lora_into_state_dict(unet_sd, text_sd, style, lora_alpha=STYLE_ALPHA)
    merge_lora_into_state_dict(unet_sd, text_sd, lcm, lora_alpha=1.0)
    twin.unet.load_state_dict(unet_sd)
    twin.text_encoder.load_state_dict(text_sd)


def assert_same_weights(torch, what, a, b):
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    differ = [k for k in pa if not torch.equal(pa[k], pb[k])]
    if differ or set(pa) != set(pb):
        raise AssertionError(f"{what}: {len(differ)} parameters differ, e.g. {differ[:3]}")


def bf16_close(torch, what, a, b) -> float:
    """Largest |a - b| of each parameter over max |b| of that parameter;
    raises above 2^-6 (bf16 keeps 8 significant bits)."""
    pb = dict(b.named_parameters())
    worst = 0.0
    for k, p in a.named_parameters():
        d = (p.float() - pb[k].float()).abs().max().item()
        worst = max(worst, d / max(pb[k].float().abs().max().item(), 1e-30))
    if not worst <= 2 ** -6:
        raise AssertionError(f"{what}: parameters differ by {worst:.3e} of their range")
    return worst


def wrapper_phase(torch, _build, smi):
    """Phase 12: a full-width pipeline's weights written in the real files'
    layouts, ingested by StreamV2VWrapper (CLIP and tokenizer included),
    prepare and 16 frames against an in-memory twin bit for bit, the step's
    kernels, the CLIP embedding against fp32 on the CPU, and a LoRA's
    strength changed under the captured graph against a fresh build."""
    import shutil

    import numpy as np

    from live2diff_tpu_torch.builder import build_pipeline, encode_prompt_for_pipeline
    from live2diff_tpu_torch.models.text_encoder import CLIPTextModelWithFinalNorm
    from live2diff_tpu_torch.stream.graph import state_tensors
    from live2diff_tpu_torch.utils.image import preprocess_image
    from live2diff_tpu_torch.wrapper import WARMUP_FRAMES, StreamV2VWrapper

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase12")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        twin = build_pipeline(BENCH_CONFIG, 512, 512, dtype=torch.bfloat16,
                              kv_cache_dtype="int8", output_uint8=True, seed=0, device=dev,
                              use_text_encoder=True, use_lcm_lora=False)
        config, (unet_sd, text_sd, style, lcm, n_style), write_s = write_pipeline_files(
            torch, root, twin)
        sizes = {f: os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root)
                 for f in fs}
        merge_into_twin(torch, twin, unet_sd, text_sd, style, lcm)
        del unet_sd, text_sd

        t0 = time.perf_counter()
        w = StreamV2VWrapper(config, height=512, width=512, use_text_encoder=True,
                             kv_cache_dtype="int8", output_type="np", seed=WRAPPER_SEED,
                             device="cuda")
        build_s = time.perf_counter() - t0
        expected_missing = (f"{config['pretrained_model_path']}/vae",)
        if w.built.missing_artifacts != expected_missing:
            raise AssertionError(f"missing artifacts {w.built.missing_artifacts}, expected "
                                 f"{expected_missing}")
        for name in ("unet", "vae", "depth_model", "text_encoder"):
            assert_same_weights(torch, f"the ingested {name} against the twin's",
                                getattr(w.built, name), getattr(twin, name))

        # the prompt: the wrapper's encode, the twin's, and fp32 on the CPU
        text = WRAPPER_TEMPLATE.replace("{}", WRAPPER_PROMPT)
        ids = torch.from_numpy(w.built.tokenizer([text]).astype(np.int64))
        encode_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            embeds = w.encode_prompt(WRAPPER_PROMPT)
            torch.cuda.synchronize()
            encode_ms.append((time.perf_counter() - t0) * 1e3)
        with torch.no_grad():
            twin_embeds = twin.text_encoder(ids.to(dev), clip_skip=CLIP_SKIP).float()
            cpu_te = CLIPTextModelWithFinalNorm(twin.text_encoder.config).eval()
            cpu_te.load_state_dict({k: v.float().cpu()
                                    for k, v in twin.text_encoder.state_dict().items()})
            cpu_embeds = cpu_te(ids, clip_skip=CLIP_SKIP)
        del cpu_te
        if not torch.equal(embeds, twin_embeds):
            raise AssertionError("the wrapper's prompt embedding differs from the twin's")
        clip_err = rel_rms(embeds.cpu(), cpu_embeds)
        if not clip_err <= CLIP_RMS_TOL:
            raise AssertionError(f"CLIP on the card: relative RMS {clip_err:.3e} against fp32 "
                                 f"on the CPU, above {CLIP_RMS_TOL}")

        rs = np.random.RandomState(5)
        frames = rs.randint(0, 256, (WARMUP_FRAMES + WRAPPER_FRAMES + 2 * UPDATE_FRAMES + 4,
                                     512, 512, 3)).astype(np.uint8)
        pre = torch.from_numpy(np.stack([preprocess_image(f, 512, 512) for f in frames])).to(dev)

        _build.reset_launch_counts()
        t0 = time.perf_counter()
        warm_out = w.prepare(WRAPPER_PROMPT, frames[:WARMUP_FRAMES])
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - t0
        prepare_counts = dict(_build.launch_counts)
        # prepare's warmup, the eager warm step, the capture (one step)
        check_counts("the wrapper's prepare (warmup, warm step, capture)", prepare_counts,
                     {k: EXPECTED_PREPARE[k] + 2 * n for k, n in EXPECTED_PER_STEP.items()}, 1)
        n_graphs = len(w.stream._graphs.graphs)
        state_t, twin_warm = twin.stream.prepare(pre[:WARMUP_FRAMES], twin_embeds,
                                                 seed=WRAPPER_SEED)
        if not np.array_equal(warm_out, twin_warm.cpu().numpy()):
            raise AssertionError("prepare: the wrapper's warmup outputs differ from the twin's")
        twin.stream.warm_frame_step(torch.float32)
        twin.stream.capture_step(state_t, torch.float32)

        # the wrapper's frames and the twin's bare stream() calls in turns
        _build.reset_launch_counts()
        times = {"wrapper": [], "stream": []}
        outs_w, outs_t = [], []
        for i in range(WRAPPER_FRAMES):
            f = WARMUP_FRAMES + i
            for name in (("wrapper", "stream") if i % 2 == 0 else ("stream", "wrapper")):
                t0 = time.perf_counter()
                if name == "wrapper":
                    outs_w.append(w(frames[f]))
                else:
                    state_t, out = twin.stream(state_t, pre[f])
                    torch.cuda.synchronize()
                    outs_t.append(out)
                times[name].append((time.perf_counter() - t0) * 1e3)
        if any(_build.launch_counts.values()) or len(w.stream._graphs.graphs) != n_graphs:
            raise AssertionError(f"the wrapper's frames captured or launched again: "
                                 f"{dict(_build.launch_counts)}")
        differ = [i for i, (a, b) in enumerate(zip(outs_w, outs_t))
                  if not np.array_equal(a, b.cpu().numpy())]
        if differ or len(outs_w) != WRAPPER_FRAMES:
            raise AssertionError(f"wrapper frames {differ} differ from the twin's")
        steady = {k: sorted(v[2:]) for k, v in times.items()}

        # update_lora_scale under the captured graph, against a fresh build
        params = dict(w.built.unet.named_parameters())
        ptrs = {k: p.data_ptr() for k, p in params.items()}
        n_updated = w.update_lora_scale("style-lora", STYLE_NEW_ALPHA)
        w.update_prompt(WRAPPER_PROMPT)  # the text encoder's new weights
        if n_updated != n_style or {k: p.data_ptr() for k, p in params.items()} != ptrs:
            raise AssertionError(f"update_lora_scale: {n_updated} parameters (expected "
                                 f"{n_style}), addresses kept: "
                                 f"{ {k: p.data_ptr() for k, p in params.items()} == ptrs}")
        del twin, state_t
        gc.collect()
        fresh_cfg = dict(config, third_party_dict=dict(config["third_party_dict"], lora_list=[
            {"lora": config["third_party_dict"]["lora_list"][0]["lora"],
             "lora_alpha": STYLE_NEW_ALPHA}]))
        fresh = build_pipeline(fresh_cfg, 512, 512, dtype=torch.bfloat16, kv_cache_dtype="int8",
                               output_uint8=True, seed=0, device=dev, use_text_encoder=True)
        weight_err = {name: bf16_close(torch, f"{name} after update_lora_scale against a fresh "
                                       f"build", getattr(w.built, name), getattr(fresh, name))
                      for name in ("unet", "text_encoder")}
        fresh.stream.set_prompt(encode_prompt_for_pipeline(fresh, text))
        state_f, _ = fresh.stream.prepare(pre[:WARMUP_FRAMES], fresh.stream._prompt_embeds[:1],
                                          seed=WRAPPER_SEED)
        for a, b in zip(state_tensors(state_f), state_tensors(w._state)):
            a.copy_(b)  # the wrapper's state, into the fresh pipeline's
        w._state.generator.manual_seed(77)
        state_f.generator.manual_seed(77)
        update_err = []
        for i in range(UPDATE_FRAMES):
            f = WARMUP_FRAMES + WRAPPER_FRAMES + i
            out_w = w(frames[f])
            state_f, out_f = fresh.stream._frame_step(state_f, pre[f], fresh.stream._prompt_embeds)
            update_err.append(rel_rms(torch.from_numpy(out_w), out_f.cpu()))
        if len(w.stream._graphs.graphs) != n_graphs:
            raise AssertionError("update_lora_scale led to a new capture")
        if not max(update_err) <= LORA_RMS_TOL:
            raise AssertionError(f"replays after update_lora_scale: relative RMS {update_err} "
                                 f"against a fresh build at {STYLE_NEW_ALPHA}")
        del fresh, state_f
        gc.collect()

        # the float32-frame graph's device kernels a step, by name
        it = iter(frames[-4:])
        prof = profile_device(torch, lambda: w(next(it)), 4)
        dev_counts = check_device_kernels(
            "the wrapper's replays", prof, EXPECTED_PER_STEP,
            lambda: profile_device(torch, lambda: w(frames[-1]), 4))
        result = dict(
            card=smi, files_bytes=sizes, write_s=write_s, wrapper_build_s=build_s,
            ingest_s=w.built.ingest_s, missing_artifacts=list(w.built.missing_artifacts),
            prompt_encode_ms=encode_ms, clip_rel_rms_vs_cpu_fp32=clip_err,
            prepare_s=prepare_s, first_step_warm_s=w.first_step_warm_s,
            capture_ms=w.capture_s * 1e3, launches_prepare=prepare_counts,
            first_img2img_ms=times["wrapper"][0],
            wrapper_frame_ms_p50=statistics.median(steady["wrapper"]),
            wrapper_frame_ms_p90=steady["wrapper"][int(0.9 * (len(steady["wrapper"]) - 1))],
            stream_frame_ms_p50=statistics.median(steady["stream"]),
            stream_frame_ms_p90=steady["stream"][int(0.9 * (len(steady["stream"]) - 1))],
            frame_ms_all=times, outputs_bit_equal_to_twin=True, frames=WRAPPER_FRAMES,
            lora_parameters_updated=n_updated, lora_weight_err_vs_fresh=weight_err,
            lora_replay_rel_rms_vs_fresh=update_err,
            device_kernels_per_step=dev_counts,
            kernels_per_step_float32_frames=prof["kernels_per_call"],
            device_ms_per_step=prof["device_ms_per_call"])
        del w
        return result
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 13: the KL codec at full width
# ---------------------------------------------------------------------------

KL_FRAMES = 16
KL_ROUNDS = 16
CODEC_REPS = 10
# the KL codec's convs are cuDNN's: no TAESD conv kernel on its path
NO_TAESD = {"conv3x3": 0, "conv3x3_s2": 0}


def codec_ms(torch, stream) -> dict:
    """Device ms (CUDA events, L2 overwritten) of the stream's codec alone:
    one encode of the step's batch (frame and depth image, or the frame)
    and one decode of the step's latent."""
    dev = torch.device("cuda")
    cfg = stream.cfg
    n = 2 if stream.depth_model is not None else 1
    gen = torch.Generator(device=dev).manual_seed(3)
    x = (torch.rand(n, cfg.height, cfg.width, 3, generator=gen, device=dev) * 2 - 1
         ).to(stream.dtype)
    z = torch.randn(1, cfg.latent_height, cfg.latent_width, 4, generator=gen,
                    device=dev).to(stream.dtype)
    with torch.no_grad():
        return dict(encode_ms=time_ms(lambda: stream.vae.encode(x), CODEC_REPS),
                    decode_ms=time_ms(lambda: stream.vae.decode(z), CODEC_REPS),
                    encode_batch=n)


def kl_phase(torch, _build, main_keep) -> dict:
    """Phase 13: phase 4's configuration with use_tiny_vae=False. The
    narrow pipeline on the card against fp32 on the CPU, the full-width
    stream (launches asserted, profiled), the codec's encode and decode
    alone beside TAESD's, and the frame in turns with phase 4's."""
    errs, depth_err, _ = small_input_check(torch, use_tiny_vae=False)
    kept = []
    result, counts = run_stream(torch, _build, KL_FRAMES, {**EXPECTED_PER_STEP, **NO_TAESD},
                                {**EXPECTED_PREPARE, **NO_TAESD}, keep=kept,
                                kv_cache_dtype="int8", use_tiny_vae=False)
    stream = kept[0][0]
    result["params"]["vae"] = sum(p.numel() for p in stream.vae.parameters())
    result["codec"] = codec = codec_ms(torch, stream)
    result["taesd_codec"] = codec_ms(torch, main_keep[0])
    result["codec_share_of_frame_p50"] = (codec["encode_ms"] + codec["decode_ms"]) / result[
        "frame_ms_p50"]
    result["small_input_rel_rms"] = errs
    result["small_input_depth_rel_rms"] = depth_err
    after = {}
    result["in_turns_with_phase_4"] = interleaved(
        torch, {"main path (TAESD)": main_keep, "KL codec": kept[0]}, KL_ROUNDS, after=after)
    main_keep[1] = after["main path (TAESD)"]
    kept.clear()
    return result, counts


# ---------------------------------------------------------------------------
# phase 14: MultiStream at full width
# ---------------------------------------------------------------------------

MULTI_SESSIONS = (2, 4)
MULTI_ROUNDS = 16
MASKED_ROUNDS = 8
# A session against its single-session twin (same seed, prompt and
# frames): the batched step at S * 2 step rows and the single one at 2 run
# other GEMM and conv algorithms in bf16, so they need not be bit-equal.
# Held: the noised latents in flight (x_t_buffer, of which a wrong
# generator, frame or prompt moves about all) within 0.05 relative RMS,
# and the uint8 outputs within 2 levels (random N(0, 0.02^2) weights make
# near-flat frames, so a relative error of the frames says little; PR 11's
# first chip run saw 1 level)
MULTI_RMS_TOL = 0.05
MULTI_UINT8_TOL = 2


def multi_phase(torch, _build, main_keep, dev_main) -> dict:
    """Phase 14: MultiStream over phase 4's pipeline at S = 2 and 4."""
    from live2diff_tpu_torch.stream.graph import state_tensors
    from live2diff_tpu_torch.stream.multi import MultiStream

    stream, single_state, _ = main_keep
    dev = torch.device("cuda")
    out = {}
    for s in MULTI_SESSIONS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(100 + s)
        prompts = torch.randn(s, 77, 768, generator=gen, device=dev)
        warm = torch.rand(s, 8, 512, 512, 3, generator=gen, device=dev) * 2 - 1
        frames = torch.randint(0, 256, (MULTI_ROUNDS + MASKED_ROUNDS + 1, s, 512, 512, 3),
                               generator=gen, device=dev, dtype=torch.uint8)
        seeds = [1000 + 10 * s + i for i in range(s)]

        # both graphs captured at construction, after an eager warm round of each
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        multi = MultiStream(stream, s)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check_counts(f"MultiStream({s}) construction (2 eager rounds, 2 captures)",
                     _build.launch_counts, EXPECTED_PER_STEP, 4)
        construct_counts = dict(_build.launch_counts)
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        states = None
        for i in range(s):
            states, _ = multi.prepare_session(states, i, warm[i], prompts[i], seed=seeds[i])
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - t0
        check_counts(f"prepare_session x {s}", _build.launch_counts, EXPECTED_PREPARE, s)
        replica = None
        if s == 2:  # a twin that never idles, for the masked rounds' check
            replica = MultiStream(stream, s)
            rstates = None
            for i in range(s):
                rstates, _ = replica.prepare_session(rstates, i, warm[i], prompts[i],
                                                     seed=seeds[i])

        # all-active rounds, in turns with phase 4's single stream
        _build.reset_launch_counts()
        times, single_times, outs = [], [], []
        for r in range(MULTI_ROUNDS):
            t0 = time.perf_counter()
            states, o = multi(states, frames[r])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            outs.append(o)
            t0 = time.perf_counter()
            single_state, _ = stream(single_state, frames[r, 0])
            torch.cuda.synchronize()
            single_times.append((time.perf_counter() - t0) * 1e3)
        for r in range(MULTI_ROUNDS if replica is not None else 0):
            rstates, _ = replica(rstates, frames[r])
        if any(_build.launch_counts.values()):
            raise AssertionError(f"MultiStream({s}) replays launched through the wrappers: "
                                 f"{dict(_build.launch_counts)}")
        for o in outs:
            if o.shape != (s, 512, 512, 3) or o.dtype != torch.uint8:
                raise AssertionError(f"MultiStream({s}) output {tuple(o.shape)} {o.dtype}")

        # each session against a single-session twin of the same seed and frames
        errs, max_abs, twins = [], 0, {}
        for i in range(s):
            st, _ = stream.prepare(warm[i], prompts[i], seed=seeds[i])
            for r in range(MULTI_ROUNDS):
                st, o = stream(st, frames[r, i])
                max_abs = max(max_abs, (outs[r][i].int() - o.int()).abs().max().item())
            errs.append(rel_rms(states.x_t_buffer[i], st.x_t_buffer))
            if i == s - 1:
                twins[i] = st
            del st
        if not (max(errs) <= MULTI_RMS_TOL and max_abs <= MULTI_UINT8_TOL):
            raise AssertionError(f"MultiStream({s}) against single sessions: latents rel RMS "
                                 f"{max(errs)} (tol {MULTI_RMS_TOL}), outputs max |d| "
                                 f"{max_abs} (tol {MULTI_UINT8_TOL})")

        # masked rounds: the last session idle, its state bit-equal across each
        idle = s - 1
        active = [i != idle for i in range(s)]
        masked_times = []
        for r in range(MASKED_ROUNDS):
            before = [t[idle].clone() for t in state_tensors(states)]
            gen_before = states.generator[idle].get_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states, _ = multi(states, frames[MULTI_ROUNDS + r], active)
            torch.cuda.synchronize()
            masked_times.append((time.perf_counter() - t0) * 1e3)
            differ = [k for k, (b, t) in enumerate(zip(before, state_tensors(states)))
                      if not torch.equal(b, t[idle])]
            if differ or not torch.equal(gen_before, states.generator[idle].get_state()):
                raise AssertionError(f"MultiStream({s}) masked round {r}: idle session's "
                                     f"tensors {differ} or generator changed")
            del before
        # fed again, the idle session matches a session that never idled
        last = frames[MULTI_ROUNDS + MASKED_ROUNDS]
        states, o = multi(states, last)
        st, ref = stream(twins[idle], last[idle])
        fed_err = rel_rms(states.x_t_buffer[idle], st.x_t_buffer)
        fed_abs = (o[idle].int() - ref.int()).abs().max().item()
        if not (fed_err <= MULTI_RMS_TOL and fed_abs <= MULTI_UINT8_TOL):
            raise AssertionError(f"MultiStream({s}): the idle session fed again is {fed_err} "
                                 f"(latents), {fed_abs} (uint8) from its single twin")
        replica_equal = None
        if replica is not None:
            rstates, ro = replica(rstates, last)
            replica_equal = torch.equal(o[idle], ro[idle])
            if not replica_equal:
                raise AssertionError("MultiStream(2): the idle session fed again differs from "
                                     "a MultiStream session that never idled")
            del replica, rstates
        del twins, st

        # device kernels a round in the profile of replays: one step's
        box = [states]

        def round_():
            box[0], _ = multi(box[0], frames[0])

        prof = profile_device(torch, round_, 4)
        dev_round = check_device_kernels(f"MultiStream({s}) replays", prof, EXPECTED_PER_STEP,
                                         lambda: profile_device(torch, round_, 4))
        if dev_round != dev_main:
            raise AssertionError(f"MultiStream({s}): a round launched {dev_round}, one "
                                 f"single-session step {dev_main}")
        plain_p50 = statistics.median(sorted(times[2:]))
        masked_p50 = statistics.median(masked_times[1:])
        single_p50 = statistics.median(single_times[2:])
        out[f"S={s}"] = dict(
            construct_s=build_s, warm_s=multi.warm_s,
            capture_ms={k: v * 1e3 for k, v in multi.capture_s.items()},
            launches_construct=construct_counts, launches_per_round=dict(
                (k, v // 4) for k, v in construct_counts.items()),
            prepare_sessions_s=prepare_s,
            round_ms_p50=plain_p50, round_ms_p90=sorted(times[2:])[int(0.9 * (len(times) - 3))],
            masked_round_ms_p50=masked_p50, masked_over_plain=masked_p50 / plain_p50,
            aggregate_fps=s * 1e3 / plain_p50, single_stream_frame_ms_p50_in_turns=single_p50,
            single_stream_fps_in_turns=1e3 / single_p50,
            aggregate_over_single=(s * 1e3 / plain_p50) / (1e3 / single_p50),
            latents_rel_rms_against_single_max=max(errs),
            max_abs_uint8_against_single=max_abs, tolerance_latents_rel_rms=MULTI_RMS_TOL,
            tolerance_uint8=MULTI_UINT8_TOL, idle_fed_again_latents_rel_rms=fed_err,
            idle_fed_again_max_abs_uint8=fed_abs,
            idle_fed_again_equals_never_idled_multistream=replica_equal,
            idle_state_bit_equal_rounds=MASKED_ROUNDS,
            device_kernels_per_round=dev_round, profile=prof,
            peak_memory_net_bytes=torch.cuda.max_memory_allocated() - start,
            stacked_state_bytes=sum(t.numel() * t.element_size()
                                    for t in state_tensors(states)),
        )
        if isinstance(prof["device_ms_per_call"], float):
            out[f"S={s}"]["device_ms_per_round"] = prof["device_ms_per_call"]
        del multi, states, outs, box
    main_keep[1] = single_state
    return out


# ---------------------------------------------------------------------------
# phase 15: the demo server over localhost
# ---------------------------------------------------------------------------

SERVER_SESSIONS = 2
SERVER_OUTPUTS = 16  # outputs each user waits for, after 8 warmup frames
SERVER_TIMEOUT_S = 90


class WSClient:
    """A minimal WebSocket client (masked frames, 7/16/64-bit lengths) for
    the demo server's ``/api/ws/{user_id}``."""

    def __init__(self, port, uid):
        import base64
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        self.buf = b""
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((f"GET /api/ws/{uid} HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                           f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n\r\n").encode())
        while b"\r\n\r\n" not in self.buf:
            self.buf += self.sock.recv(4096)
        head, _, self.buf = self.buf.partition(b"\r\n\r\n")
        if b"101" not in head.split(b"\r\n")[0]:
            raise AssertionError(f"WebSocket handshake refused: {head[:80]!r}")

    def _read(self, n):
        while len(self.buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("server closed the WebSocket")
            self.buf += chunk
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def send(self, payload, opcode):
        mask = os.urandom(4)
        n = len(payload)
        header = bytes([0x80 | opcode])
        if n < 126:
            header += bytes([0x80 | n])
        elif n < (1 << 16):
            header += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            header += bytes([0x80 | 127]) + struct.pack(">Q", n)
        import numpy as np

        m = np.frombuffer(mask * (n // 4 + 1), np.uint8)[:n]
        self.sock.sendall(header + mask + (np.frombuffer(payload, np.uint8) ^ m).tobytes())

    def recv(self):
        hdr = self._read(2)
        n = hdr[1] & 0x7F
        if n == 126:
            n = struct.unpack(">H", self._read(2))[0]
        elif n == 127:
            n = struct.unpack(">Q", self._read(8))[0]
        return hdr[0] & 0xF, self._read(n)


def mjpeg_reader(port, uid, frames, stop):
    """Collect the JPEG frames of ``/api/stream/{uid}`` as (arrival time,
    bytes) until ``stop`` is set."""
    import socket

    c = socket.create_connection(("127.0.0.1", port), timeout=30)
    c.sendall(f"GET /api/stream/{uid} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    c.settimeout(0.2)
    buf = b""
    while not stop.is_set():
        try:
            chunk = c.recv(1 << 20)
        except socket.timeout:
            continue
        if not chunk:
            break
        buf += chunk
        while True:
            a, b = buf.find(b"\xff\xd8"), buf.find(b"\xff\xd9")
            if a == -1 or b == -1:
                break
            frames.append((time.perf_counter(), buf[a:b + 2]))
            buf = buf[b + 2:]
    c.close()


def server_user(port, uid, jpegs, frames, log):
    """One user: send a JPEG on each ``send_frame``, one at a time once
    streaming (the next after an output or 0.5 s), until
    ``SERVER_OUTPUTS`` outputs came back."""
    ws = WSClient(port, uid)
    sent, t0 = 0, time.perf_counter()
    try:
        while len(frames) < SERVER_OUTPUTS and time.perf_counter() - t0 < SERVER_TIMEOUT_S:
            _, data = ws.recv()
            if json.loads(data).get("status") != "send_frame":
                continue
            seen = len(frames)
            if sent >= 8:  # streaming: wait for the last frame's output
                deadline = time.perf_counter() + 0.5
                while len(frames) == seen and time.perf_counter() < deadline:
                    time.sleep(0.002)
            ws.send(json.dumps({"prompt": f"user {uid}"}).encode(), 0x1)
            ws.send(jpegs[sent % len(jpegs)], 0x2)
            sent += 1
    finally:
        ws.sock.close()
        log[uid] = sent


def server_phase(torch) -> dict:
    """Phase 15: serve/server.py's BatchedDemoPipeline (--sessions 2, 512x512,
    the server's default flags) on a free port in this process; two
    WebSocket users each send JPEG frames and read MJPEG back."""
    import asyncio
    import io
    import socket
    import threading

    import numpy as np
    from PIL import Image

    from live2diff_tpu_torch.serve import framepump, server

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pipeline = server.BatchedDemoPipeline(BENCH_CONFIG, 512, 512, SERVER_SESSIONS,
                                          device="cuda")
    build_s = time.perf_counter() - t0
    app = server.App(pipeline, max_users=SERVER_SESSIONS)
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    loop = asyncio.new_event_loop()
    started, shutdown = threading.Event(), []

    async def serve():
        srv = await asyncio.start_server(app.handle, "127.0.0.1", port)
        shutdown.append(asyncio.Event())
        started.set()
        await shutdown[0].wait()
        srv.close()

    def run_loop():
        loop.run_until_complete(serve())
        pending = asyncio.all_tasks(loop)  # connection handlers, the dispatcher
        for task in pending:
            task.cancel()
        loop.run_until_complete(asyncio.gather(*pending, return_exceptions=True))
        loop.run_until_complete(loop.shutdown_default_executor())
        loop.close()

    loop_thread = threading.Thread(target=run_loop, daemon=True)
    loop_thread.start()
    if not started.wait(30):
        raise AssertionError("the demo server did not start")
    rs = np.random.RandomState(0)
    jpegs = []
    for _ in range(8):
        buf = io.BytesIO()
        Image.fromarray(rs.randint(0, 256, (512, 512, 3)).astype(np.uint8)).save(
            buf, format="JPEG", quality=90)
        jpegs.append(buf.getvalue())
    encoders_before = dict(server.jpeg_encoder_counts)
    users = [f"u{i}" for i in range(SERVER_SESSIONS)]
    outputs = {u: [] for u in users}
    sent, stop = {}, threading.Event()
    readers = [threading.Thread(target=mjpeg_reader, args=(port, u, outputs[u], stop),
                                daemon=True) for u in users]
    for t in readers:
        t.start()
    time.sleep(0.2)
    t0 = time.perf_counter()
    clients = [threading.Thread(target=server_user, args=(port, u, jpegs, outputs[u], sent),
                                daemon=True) for u in users]
    for t in clients:
        t.start()
    for t in clients:
        t.join(SERVER_TIMEOUT_S + 10)
    wall_s = time.perf_counter() - t0
    stop.set()
    for t in readers:
        t.join(5)
    loop.call_soon_threadsafe(shutdown[0].set)
    loop_thread.join(30)
    if loop_thread.is_alive():
        raise AssertionError("the demo server's event loop did not stop")
    per_user = {}
    for u in users:
        got = outputs[u]
        if len(got) < SERVER_OUTPUTS:
            raise AssertionError(f"demo server: user {u} got {len(got)} outputs of "
                                 f"{SERVER_OUTPUTS} ({sent.get(u)} frames sent)")
        for _, jpg in got:
            arr = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"))
            if arr.shape != (512, 512, 3):
                raise AssertionError(f"demo server: user {u} got a {arr.shape} frame")
        span = got[-1][0] - got[0][0]
        per_user[u] = dict(frames_sent=sent.get(u), outputs=len(got),
                           fps=(len(got) - 1) / span if span > 0 else None)
    encoders = {k: v - encoders_before[k] for k, v in server.jpeg_encoder_counts.items()}
    del pipeline, app
    return dict(sessions=SERVER_SESSIONS, build_s=build_s, wall_s=wall_s, users=per_user,
                jpeg_encoder=("libjpeg (framepump)" if framepump.available() else "Pillow"),
                mjpeg_frames_by_encoder=encoders)


# ---------------------------------------------------------------------------
# phase 16: motion-module training
# ---------------------------------------------------------------------------

# the JAX trainer's non-tiny defaults (live2diff_tpu/train.py:45-62, 323-324)
TRAIN_CONFIG = dict(batch=2, clip_len=4, height=256, width=256, lr=1e-4, weight_decay=0.01,
                    seed=0)
TRAIN_STEPS = 20  # the counted and timed steps (the main path of this phase)
TRAIN_PROFILE_STEPS = 3
TRAIN_RESUME_STEPS = 2
# attention calls a training step, each through FlashAttentionTrain: the 16
# spatial transformers' self- and cross-attentions and the 20 motion
# modules' two temporal attentions; all but the first transformer's two
# need a gradient (its inputs come from frozen layers only), so 70 of them
# launch the backward
TRAIN_FWD_PER_STEP, TRAIN_BWD_PER_STEP = 72, 70
# the same by route (ops/flash_train.py:train_route): the short route takes
# the 40 clip-mode temporal attentions (S = 4) and the 4 x 4 latent's
# self-attention (S = 16, in the mid block, which has a backward); the
# tiled route the other self-attentions (S = 64-1024) and every
# cross-attention (77 keys)
TRAIN_ROUTES_PER_STEP = {"flash_train_fwd:short": 41, "flash_train_fwd:tiled": 31,
                         "flash_train_bwd:short": 41, "flash_train_bwd:tiled": 29}
# the fp32 training kernels against their plain versions: max error over
# max |plain|. Both compute in fp32 (the plain products with TF32 off), so
# only the order of the sums differs (~1e-6); a wrong tile or mask gives
# errors of order 1
TRAIN_KERNEL_TOL = 1e-4
# the narrow trainer on the card against fp32 on the CPU, TF32 off: the loss
# and all motion gradients together, relative RMS. fp32 on both sides with
# sums in other orders through a whole UNet and its backward
TRAIN_NARROW_TOL = 1e-3
# a resumed run against the uninterrupted one on the same card: the state is
# restored bit for bit; the steps after it may run library kernels whose
# sums are not ordered (cuDNN, cuBLAS), so their losses are held within
TRAIN_RESUME_TOL = 1e-5


def record_attention_shapes(flash_train):
    """Wrap the training pair's wrappers (the names ``FlashAttentionTrain``
    calls) to count their calls by (q shape, k shape, scale); returns the
    counts and a function that restores the wrappers. The wrapped calls
    launch as before."""
    shapes = defaultdict(lambda: [0, 0])
    fwd, bwd = flash_train.flash_train_fwd, flash_train.flash_train_bwd

    def rec_fwd(q, k, v, scale):
        shapes[tuple(q.shape), tuple(k.shape), scale][0] += 1
        return fwd(q, k, v, scale)

    def rec_bwd(q, k, v, o, lse, do, scale):
        shapes[tuple(q.shape), tuple(k.shape), scale][1] += 1
        return bwd(q, k, v, o, lse, do, scale)

    flash_train.flash_train_fwd, flash_train.flash_train_bwd = rec_fwd, rec_bwd

    def undo():
        flash_train.flash_train_fwd, flash_train.flash_train_bwd = fwd, bwd

    return shapes, undo


def check_train_attention(torch, gen, dev, shapes):
    """Both training kernels against their plain versions at every shape a
    training step gave them, fp32, with their route, times, the plain
    versions', SDPA's (fp32, forward, and its backward alone: a yardstick
    the port never calls) and the bounds: the products as 3 TF32 products
    each (3xTF32, the least time for fp32-accurate products on this card),
    the fp32 lanes' time beside it. Returns (forward rows, backward rows)."""
    import torch.nn.functional as F

    from live2diff_tpu_torch.ops.flash_train import (
        flash_train_bwd, flash_train_bwd_plain, flash_train_fwd, flash_train_fwd_plain,
        train_route,
    )

    fwd_rows, bwd_rows = [], []
    for (qs, ks, scale), (n_fwd, n_bwd) in sorted(shapes.items()):
        q, do = (torch.randn(qs, generator=gen, device=dev) for _ in range(2))
        k, v = (torch.randn(ks, generator=gen, device=dev) for _ in range(2))
        out, lse = flash_train_fwd(q, k, v, scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_train_fwd_plain(q, k, v, scale)
        err_o, rel_o = compare(out, ref_out, TRAIN_KERNEL_TOL)
        err_l, rel_l = compare(lse, ref_lse, TRAIN_KERNEL_TOL)
        grads = flash_train_bwd(q, k, v, out, lse, do, scale)
        torch.cuda.synchronize()
        refs = flash_train_bwd_plain(q, k, v, ref_out, ref_lse, do, scale)
        errs = [compare(g, r, TRAIN_KERNEL_TOL) for g, r in zip(grads, refs)]
        del refs, ref_out, ref_lse

        leaves = [x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v)]
        do_t = do.transpose(1, 2)
        sdpa_out = F.scaled_dot_product_attention(*leaves, scale=scale)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(*leaves, scale=scale)

        def sdpa_bwd():
            return torch.autograd.grad(sdpa_out, leaves, do_t, retain_graph=True)

        n, sq, h, d = qs
        sk = ks[1]
        pairs = n * h * sq * sk
        rows_lse = n * h * sq
        f_bytes = 4 * (2 * q.numel() + k.numel() + v.numel() + rows_lse)
        b_bytes = 4 * (4 * q.numel() + 2 * k.numel() + 2 * v.numel() + rows_lse)
        # the backward's exponentials twice: dK/dV and dQ each recompute P
        f_ms, f_by = bound(f_bytes, (3 * 4 * pairs * d, "tf32"), exps=pairs)
        b_ms, b_by = bound(b_bytes, (3 * 10 * pairs * d, "tf32"), exps=2 * pairs)
        f_lanes = bound(f_bytes, (4 * pairs * d, "fp32"), exps=pairs)[0]
        b_lanes = bound(b_bytes, (10 * pairs * d, "fp32"), exps=2 * pairs)[0]
        shape = f"q[{n},{sq},{h},{d}] k[{n},{sk},{h},{d}] scale {scale:.6g}"
        route = train_route(sq, sk, d)
        lib_fwd = time_ms(sdpa_fwd, 10)
        lib_bwd = time_ms(sdpa_bwd, 10)
        f_kernel_ms = time_ms(lambda: flash_train_fwd(q, k, v, scale), 10)
        b_kernel_ms = time_ms(lambda: flash_train_bwd(q, k, v, out, lse, do, scale), 10)
        fwd_rows.append(dict(
            shape=shape, route=route, calls=n_fwd, max_abs_err=max(err_o, err_l),
            rel_err=max(rel_o, rel_l), tol=TRAIN_KERNEL_TOL, ms=f_kernel_ms,
            plain_ms=time_ms(lambda: flash_train_fwd_plain(q, k, v, scale), 2),
            bound_ms=f_ms, bound_by=f_by, bound_share=f_ms / f_kernel_ms,
            bound_fp32_lanes_ms=f_lanes, library_ms=lib_fwd))
        bwd_rows.append(dict(
            shape=shape, route=route, calls=n_bwd, max_abs_err=max(e for e, _ in errs),
            rel_err=max(r for _, r in errs), tol=TRAIN_KERNEL_TOL, ms=b_kernel_ms,
            plain_ms=time_ms(lambda: flash_train_bwd_plain(q, k, v, out, lse, do, scale), 2),
            bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / b_kernel_ms,
            bound_fp32_lanes_ms=b_lanes, library_ms=lib_bwd,
            sdpa_fwd_plus_bwd_ms=lib_fwd + lib_bwd))
        del q, k, v, do, out, lse, grads, leaves, sdpa_out
    return fwd_rows, bwd_rows


def narrow_trainer_check(torch, _build):
    """Phase 3's narrow UNet (every weight drawn, the zero-initialised ones
    too, so every motion gradient is nonzero), with its depth branch: one
    diffusion loss and its backward on the card and in fp32 on the CPU, the
    same clips, t and noise. Returns the loss's relative error and the
    motion gradients' relative RMS error (all together, and the worst
    tensor's)."""
    from live2diff_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
    from live2diff_tpu_torch.parallel.train import (
        alphas_cumprod, diffusion_loss, is_motion_param, make_optimizer,
    )

    gen = torch.Generator().manual_seed(16)
    cpu = UNet3DConditionModel(UNetConfig(**SMALL_UNET))
    fan_in_init_(cpu, gen)
    card = UNet3DConditionModel(UNetConfig(**SMALL_UNET)).cuda()
    card.load_state_dict(cpu.state_dict())
    batch = {"latents": torch.randn(2, 4, 8, 8, 4, generator=gen),
             "text": torch.randn(2, 77, 64, generator=gen),
             "depth": torch.randn(2, 4, 8, 8, 4, generator=gen)}
    t, noise = torch.tensor([41, 877]), torch.randn(2, 4, 8, 8, 4, generator=gen)
    losses, grads = [], []
    for unet, dev in ((cpu, "cpu"), (card, "cuda")):
        make_optimizer(unet)
        _build.reset_launch_counts()
        loss = diffusion_loss(unet, {k: x.to(dev) for k, x in batch.items()},
                              alphas_cumprod(device=dev), t=t.to(dev), noise=noise.to(dev))
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.float().cpu() for n, p in unet.named_parameters()
                      if is_motion_param(n)})
    counts = dict(_build.launch_counts)
    if (counts["flash_train_fwd"], counts["flash_train_bwd"]) != (TRAIN_FWD_PER_STEP,
                                                                 TRAIN_BWD_PER_STEP):
        raise AssertionError(f"narrow trainer: training kernels launched {counts}")
    num = sum((grads[1][n] - g).pow(2).sum().item() for n, g in grads[0].items())
    den = sum(g.pow(2).sum().item() for g in grads[0].values())
    worst = max((rel_rms(grads[1][n], g), n) for n, g in grads[0].items())
    result = dict(loss_cpu=losses[0], loss_card=losses[1],
                  loss_rel_err=abs(losses[1] - losses[0]) / abs(losses[0]),
                  grad_rel_rms=(num / den) ** 0.5, worst_tensor_rel_rms=worst[0],
                  worst_tensor=worst[1], motion_tensors=len(grads[0]), tol=TRAIN_NARROW_TOL)
    if not max(result["loss_rel_err"], result["grad_rel_rms"]) <= TRAIN_NARROW_TOL:
        raise AssertionError(f"narrow trainer: card against CPU {result}")
    return result


def motion_state(torch, trainer):
    """Copies of the motion parameters and of the AdamW state."""
    from live2diff_tpu_torch.parallel.train import is_motion_param

    params = {n: p.detach().clone() for n, p in trainer.unet.named_parameters()
              if is_motion_param(n)}
    opt = [{k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
           for s in trainer.state.optimizer.state.values()]
    return params, opt


def training_phase(torch, _build, smi, gen, dev):
    """Phase 16: the training kernels at every training shape, the narrow
    trainer against the CPU, and ``Trainer`` at the JAX trainer's full-width
    defaults for TRAIN_STEPS counted steps, profiled, saved and resumed."""
    import dataclasses
    import shutil

    from live2diff_tpu_torch.ops import flash_train
    from live2diff_tpu_torch.ops.flash_train import train_route
    from live2diff_tpu_torch.parallel.train import is_motion_param
    from live2diff_tpu_torch.train import Trainer, TrainerConfig, synthetic_clips

    result = {"tf32": dict(cuda_matmul=torch.backends.cuda.matmul.allow_tf32,
                           cudnn=torch.backends.cudnn.allow_tf32,
                           float32_matmul_precision=torch.get_float32_matmul_precision())}
    result["narrow_trainer"] = narrow_trainer_check(torch, _build)
    print(f"narrow trainer, card against CPU: {json.dumps(result['narrow_trainer'])}",
          flush=True)

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase16")
    shutil.rmtree(root, ignore_errors=True)
    cfg = TrainerConfig(**TRAIN_CONFIG, steps=10 ** 9, log_every=0, save_every=0,
                        ckpt_dir=root)
    try:
        t0 = time.perf_counter()
        trainer = Trainer(cfg)  # on the card: the entry's default
        torch.cuda.synchronize()
        result["build_s"] = time.perf_counter() - t0
        named = list(trainer.unet.named_parameters())
        result["unet_parameters"] = sum(p.numel() for _, p in named)
        result["motion_parameters"] = sum(p.numel() for n, p in named if is_motion_param(n))
        frozen = {n: p.detach().clone() for n, p in named if not is_motion_param(n)}
        vae = [p.detach().clone() for p in trainer.vae.parameters()]
        motion_before, _ = motion_state(torch, trainer)
        clips = next(synthetic_clips(cfg))

        # one step logs every shape the attention is given
        shapes, undo = record_attention_shapes(flash_train)
        try:
            first_loss = trainer.train_step(clips)
        finally:
            undo()
        calls = [sum(c[i] for c in shapes.values()) for i in (0, 1)]
        if calls != [TRAIN_FWD_PER_STEP, TRAIN_BWD_PER_STEP]:
            raise AssertionError(f"training step: attention calls {calls}, expected "
                                 f"{[TRAIN_FWD_PER_STEP, TRAIN_BWD_PER_STEP]}: {dict(shapes)}")
        print("training step's attention shapes (q, k, scale): calls forward, backward: "
              + json.dumps({f"{q} {k} {s:.6g}": c for (q, k, s), c in sorted(shapes.items())}))
        by_route = Counter()
        for (qs, ks, _), (n_fwd, n_bwd) in shapes.items():
            route = train_route(qs[1], ks[1], qs[3])
            if qs[1] == ks[1] == 4 and route != "short":
                raise AssertionError(f"the clip-mode attention q{qs} takes the {route} route")
            by_route[f"flash_train_fwd:{route}"] += n_fwd
            by_route[f"flash_train_bwd:{route}"] += n_bwd
        if dict(by_route) != TRAIN_ROUTES_PER_STEP:
            raise AssertionError(f"training step: attention calls by route {dict(by_route)}, "
                                 f"expected {TRAIN_ROUTES_PER_STEP}")

        # the main path of this phase: TRAIN_STEPS steps, counted and timed
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        routes_before = dict(flash_train.route_counts)
        losses, ms = [first_loss], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(trainer.train_step(clips))  # float(): synchronises
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = dict(_build.launch_counts)
        routes = {k: v - routes_before[k] for k, v in flash_train.route_counts.items()}
        result["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        result["peak_memory_net_bytes"] = result["peak_memory_bytes"] - base
        expected = {k: 0 for k in counts}
        expected.update(flash_train_fwd=TRAIN_FWD_PER_STEP * TRAIN_STEPS,
                        flash_train_bwd=TRAIN_BWD_PER_STEP * TRAIN_STEPS)
        if counts != expected:
            raise AssertionError(f"training steps launched {counts}, expected {expected}")
        expected_routes = {k: n * TRAIN_STEPS for k, n in TRAIN_ROUTES_PER_STEP.items()}
        if routes != expected_routes:
            raise AssertionError(f"training steps launched by route {routes}, expected "
                                 f"{expected_routes}")
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"training: non-finite loss in {losses}")
        ms_sorted = sorted(ms)
        p50 = statistics.median(ms)
        result.update(
            steps=TRAIN_STEPS, launches=counts, launches_by_route=routes, losses=losses,
            step_ms_all=ms,
            step_ms_p50=p50, step_ms_p90=ms_sorted[int(0.9 * (len(ms) - 1))],
            clips_per_s=cfg.batch * 1e3 / p50)

        prof = profile_device(torch, lambda: trainer.train_step(clips), TRAIN_PROFILE_STEPS)
        expected_dev = {name: 0 for name in _build.launch_counts}
        expected_dev.update(flash_train_fwd=TRAIN_FWD_PER_STEP,
                            flash_train_bwd=TRAIN_BWD_PER_STEP)
        result["device_kernels_per_step"] = check_device_kernels(
            "training steps", prof, expected_dev,
            lambda: profile_device(torch, lambda: trainer.train_step(clips), TRAIN_PROFILE_STEPS),
            routes=TRAIN_ROUTES_PER_STEP)
        if isinstance(prof["device_ms_per_call"], float):
            attn_by = {k: sum(v) for k, v in prof["device_ms_by_wrapper"].items()
                       if k.startswith("flash_train")}
            prof["attention_kernels_ms_per_step_by_route"] = attn_by
            attn = sum(attn_by.values())
            prof["attention_kernels_ms_per_step"] = attn
            prof["attention_share_of_device_ms"] = attn / prof["device_ms_per_call"]
            prof["device_ms_over_step_ms_p50"] = prof["device_ms_per_call"] / p50
        result["profile"] = prof

        # frozen weights bit-equal, the motion modules moved
        for n, p in trainer.unet.named_parameters():
            if not is_motion_param(n) and not torch.equal(p, frozen[n]):
                raise AssertionError(f"training moved the frozen parameter {n}")
        if not all(torch.equal(a, b) for a, b in zip(trainer.vae.parameters(), vae)):
            raise AssertionError("training moved the VAE")
        motion_now, _ = motion_state(torch, trainer)
        still = [n for n in motion_now if torch.equal(motion_now[n], motion_before[n])]
        if still:
            raise AssertionError(f"training left {len(still)} motion parameters where they "
                                 f"were: {still[:5]}")
        del frozen, vae, motion_before, motion_now

        # save, resume into a fresh trainer, and go on in both
        t0 = time.perf_counter()
        path = trainer.save()
        result["save_s"] = time.perf_counter() - t0
        result["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        t0 = time.perf_counter()
        resumed = Trainer(dataclasses.replace(cfg, resume=True))
        torch.cuda.synchronize()
        result["resume_s"] = time.perf_counter() - t0
        if resumed.state.step != trainer.state.step:
            raise AssertionError(f"resumed at step {resumed.state.step}, saved at "
                                 f"{trainer.state.step}")
        (pa, oa), (pb, ob) = motion_state(torch, trainer), motion_state(torch, resumed)
        same = (all(torch.equal(pa[n], pb[n]) for n in pa) and len(oa) == len(ob)
                and all(torch.equal(x[k], y[k]) if torch.is_tensor(x[k]) else x[k] == y[k]
                        for x, y in zip(oa, ob) for k in x)
                and torch.equal(trainer.state.generator.get_state(),
                                resumed.state.generator.get_state()))
        if not same:
            raise AssertionError("the resumed state is not the saved one")
        del pa, oa, pb, ob
        go_on = [trainer.train_step(clips) for _ in range(TRAIN_RESUME_STEPS)]
        go_resumed = [resumed.train_step(clips) for _ in range(TRAIN_RESUME_STEPS)]
        rel = max(abs(a - b) / abs(a) for a, b in zip(go_on, go_resumed))
        pa, _ = motion_state(torch, trainer)
        pb, _ = motion_state(torch, resumed)
        result["resume"] = dict(step=resumed.state.step, losses=go_on,
                                losses_resumed=go_resumed, loss_rel_err=rel,
                                losses_bitwise=go_on == go_resumed,
                                params_max_abs_diff=max((pa[n] - pb[n]).abs().max().item()
                                                        for n in pa),
                                tol=TRAIN_RESUME_TOL)
        if not rel <= TRAIN_RESUME_TOL:
            raise AssertionError(f"resumed run off the uninterrupted one: {result['resume']}")
        del pa, pb, resumed, trainer
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

    fwd_rows, bwd_rows = check_train_attention(torch, gen, dev, shapes)
    per = (f"training step at {cfg.height}x{cfg.width}, batch {cfg.batch}, clip "
           f"{cfg.clip_len}, fp32 (sum over shapes of calls x ms)")
    src, replaces = "live2diff_tpu_torch/csrc/flash_train.cu", "live2diff_tpu/ops/flash_attention.py:143"
    entries = []
    for name, rows in (("flash_train_fwd", fwd_rows), ("flash_train_bwd", bwd_rows)):
        entry = dict(summarise(name, src, replaces, rows), per=per, per_what="training step")
        entry["bound_fp32_lanes_ms"] = sum(r["calls"] * r["bound_fp32_lanes_ms"] for r in rows)
        # the same sums by route, each per training step
        entry["routes"] = {
            route: {key: sum(r["calls"] * r[key] for r in rows if r["route"] == route)
                    for key in ("ms", "plain_ms", "bound_ms", "bound_fp32_lanes_ms",
                                "library_ms")}
            | {"calls": sum(r["calls"] for r in rows if r["route"] == route)}
            for route in TRAIN_ROUTES}
        entries.append(entry)
    return result, entries, dict(shapes)


# ---------------------------------------------------------------------------
# phase 17: warm start from a primed engine directory, and the tools
# ---------------------------------------------------------------------------

START_TAG = "START_RESULT "
START_PROMPT = "a cat in the rain"
START_TIMEOUT_S = 600
# the wrappers of the main path, each of which a warm first frame launches
MAIN_PATH_WRAPPERS = ("stream_attention_int8", "flash_attention", "conv3x3", "conv3x3_s2",
                      "layer_norm")
TRACE_FRAMES = 8
TRACE_DEVICE_TOL = 0.03  # trace_step's device ms a frame against phase 4's profile
PARITY_FRAMES = 14  # toonyou.yaml's 4 steps: 8 warmup frames, a lag of 3, 3 outputs


def start_run(mode: str, root: str, engine_dir: str, out_npy: str, t_spawn: str) -> int:
    """One start of the bench-default ``StreamV2VWrapper`` in a fresh
    process, importing the port's copy under ``root`` (its ``BUILD_DIR``,
    ``root/build/kernels``, is its own): construction, ``prepare`` on 8
    frames and one frame, its output saved to ``out_npy``. ``cold`` then
    primes ``engine_dir``; ``warm`` empties the copy's build directory
    first, loads from ``engine_dir`` and afterwards offers ``load_engines`` a
    copy of it with one flipped byte in a library. Prints one line,
    ``START_TAG`` and the times as JSON; ``t_spawn`` is the parent's
    ``time.time()`` just before it started this process."""
    import shutil

    sys.path.insert(0, root)
    import numpy as np
    import torch

    import live2diff_tpu_torch
    from live2diff_tpu_torch import aot
    from live2diff_tpu_torch.ops import _build
    from live2diff_tpu_torch.wrapper import StreamV2VWrapper

    if not os.path.abspath(live2diff_tpu_torch.__file__).startswith(os.path.abspath(root)):
        raise AssertionError(f"imported {live2diff_tpu_torch.__file__}, not the copy in {root}")
    kernels_dir = _build.BUILD_DIR
    if mode == "warm":
        shutil.rmtree(kernels_dir, ignore_errors=True)
    build_calls = []  # seconds in each _build.build call: nvcc and its checks
    build = _build.build

    def timed_build(names):
        t0 = time.perf_counter()
        try:
            return build(names)
        finally:
            build_calls.append(time.perf_counter() - t0)

    _build.build = timed_build

    def built():
        return sorted(os.listdir(kernels_dir)) if os.path.isdir(kernels_dir) else []

    t0 = time.perf_counter()
    wrapper = StreamV2VWrapper(BENCH_CONFIG, height=512, width=512, output_type="np",
                               use_text_encoder=False, kv_cache_dtype="int8",
                               engine_dir=engine_dir, seed=0)
    ctor_s = time.perf_counter() - t0
    aot_s = wrapper.stream._aot_load_s if wrapper.aot_hit else 0.0
    rng = np.random.RandomState(0)
    warm_frames = rng.randint(0, 256, (8, 512, 512, 3)).astype(np.uint8)
    frame = rng.randint(0, 256, (512, 512, 3)).astype(np.uint8)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    wrapper.prepare(START_PROMPT, warm_frames)
    prepare_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = wrapper(frame)  # img2img synchronises the card
    first_step_s = time.perf_counter() - t0
    to_first_frame_s = time.time() - float(t_spawn)
    launches = dict(_build.launch_counts)
    np.save(out_npy, out)
    result = dict(mode=mode, aot_hit=wrapper.aot_hit, build_s=ctor_s - aot_s, aot_load_s=aot_s,
                  prepare_s=prepare_s, first_step_s=first_step_s,
                  to_first_frame_s=to_first_frame_s, build_calls=len(build_calls),
                  nvcc_s=sum(build_calls), launches=launches, built=built())
    key = aot.engine_key(wrapper.stream.device)
    if mode == "cold":
        t0 = time.perf_counter()
        result["primed"] = wrapper.prime_aot()
        result["prime_s"] = time.perf_counter() - t0
        with open(os.path.join(aot.engine_path(engine_dir, key), aot.MANIFEST)) as f:
            result["manifest_files"] = sorted(e["file"] for e in json.load(f)["files"].values())
    else:
        bad_root = engine_dir + "-tampered"
        shutil.copytree(engine_dir, bad_root)
        bad = aot.engine_path(bad_root, key)
        with open(os.path.join(bad, aot.MANIFEST)) as f:
            lib = os.path.join(bad, json.load(f)["files"]["flash_attention"]["file"])
        with open(lib, "rb") as f:
            data = bytearray(f.read())
        data[len(data) // 2] ^= 0x01
        with open(lib, "wb") as f:
            f.write(data)
        listing, libs = sorted(os.listdir(bad)), dict(_build._LIBS)
        refused = not aot.load_engines(wrapper.stream, bad_root)
        with open(lib, "rb") as f:
            kept = f.read() == bytes(data) and sorted(os.listdir(bad)) == listing
        try:
            aot.verified_libraries(bad, key)
            reason = None
        except aot.EngineDirRefused as e:
            reason = str(e)
        result["tampered"] = dict(refused=refused, kept=kept, libs_unchanged=_build._LIBS == libs,
                                  reason=reason)
        result["built_after"] = built()
    print(START_TAG + json.dumps(result), flush=True)
    return 0


def start_phase(torch) -> dict:
    """Phase 17, first part: a cold and a warm start of the bench-default
    wrapper, each in a process of its own (``start_run``), from a copy of
    the port whose build directory starts empty."""
    import shutil
    import tempfile

    import numpy as np

    root = tempfile.mkdtemp(prefix="live2diff-start-")
    try:
        here = os.path.dirname(os.path.abspath(__file__))
        shutil.copytree(os.path.join(here, "live2diff_tpu_torch"),
                        os.path.join(root, "live2diff_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        engines = os.path.join(root, "engines")
        runs = {}
        for mode in ("cold", "warm"):
            out = os.path.join(root, f"{mode}.npy")
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--start", mode, root, engines, out,
                 repr(time.time())],
                cwd=root, capture_output=True, text=True, timeout=START_TIMEOUT_S)
            line = next((ln for ln in proc.stdout.splitlines() if ln.startswith(START_TAG)), None)
            if proc.returncode != 0 or line is None:
                raise AssertionError(f"{mode} start: rc {proc.returncode}\n{proc.stdout[-3000:]}"
                                     f"\n{proc.stderr[-6000:]}")
            runs[mode] = json.loads(line[len(START_TAG):])
            runs[mode]["first_frame"] = np.load(out)
        cold, warm = runs["cold"], runs["warm"]
        # the manifest holds the libraries the cold frame built, and no other
        if not cold["primed"] or cold["aot_hit"] or cold["built"] != cold["manifest_files"]:
            raise AssertionError(f"cold start: hit {cold['aot_hit']}, primed {cold['primed']}, "
                                 f"built {cold['built']}, manifest {cold['manifest_files']}")
        if not warm["aot_hit"] or warm["build_calls"] or warm["built"] or warm["built_after"]:
            raise AssertionError(f"warm start: hit {warm['aot_hit']}, {warm['build_calls']} "
                                 f"build calls, built {warm['built']} {warm['built_after']}")
        idle = [k for k in MAIN_PATH_WRAPPERS if not warm["launches"][k]]
        if idle:
            raise AssertionError(f"warm start: {idle} never launched: {warm['launches']}")
        a, b = cold.pop("first_frame"), warm.pop("first_frame")
        if a.shape != (512, 512, 3) or a.dtype != np.uint8 or not np.array_equal(a, b):
            raise AssertionError(f"warm first frame {b.shape} {b.dtype} differs from the cold "
                                 f"one {a.shape} {a.dtype}")
        t = warm["tampered"]
        if not (t["refused"] and t["kept"] and t["libs_unchanged"] and "sha256" in t["reason"]):
            raise AssertionError(f"a tampered library: {t}")
        return dict(cold=cold, warm=warm, first_frames_bit_equal=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def tools_phase(torch, main_keep, main_path) -> dict:
    """Phase 17, second part: the tools on phase 4's kept stream (trace_step,
    profile_stages) and parity's tiny self-comparison on the card."""
    import itertools
    import shutil
    import tempfile

    import numpy as np
    from PIL import Image

    from live2diff_tpu_torch.tools import parity, profile_stages, trace_step

    stream, _, frames = main_keep
    order = itertools.cycle(range(len(frames)))

    def step():
        main_keep[1], _ = stream(main_keep[1], frames[next(order)])

    seconds, t0 = {}, time.perf_counter()
    expected = main_path["kernels_per_step"]
    traced = trace_step.trace(step, stream.device, frames=TRACE_FRAMES, top=12)
    # every record in the frame that launched it; each frame replays the
    # same graph, so the names of the fullest frames are the step's kernels
    # and a frame short of some (dropped_by_frame) lost them in the trace
    if traced["unassigned"] or traced["kernels_full"] != expected:
        raise AssertionError(f"trace_step: {traced['kernels_full']} kernels a step (by frame "
                             f"{traced['kernels_by_frame']}, dropped "
                             f"{traced['dropped_by_frame']}), {traced['unassigned']} records "
                             f"launched in no frame {traced['unassigned_names']}; phase 4 "
                             f"{expected} a step")
    rel = traced["device_ms"] / main_path["device_ms_per_step"] - 1
    if abs(rel) > TRACE_DEVICE_TOL:
        raise AssertionError(f"trace_step: {traced['device_ms']:.3f} device ms a frame, phase "
                             f"4's profile {main_path['device_ms_per_step']:.3f} ({rel:+.3%})")
    traced["device_ms_over_phase_4"] = rel + 1
    seconds["trace_step"], t0 = time.perf_counter() - t0, time.perf_counter()

    main_keep[1], stages = profile_stages.profile_stages(stream, main_keep[1], frames[0])
    seconds["profile_stages"], t0 = time.perf_counter() - t0, time.perf_counter()

    root = tempfile.mkdtemp(prefix="live2diff-parity-")
    try:
        rng = np.random.RandomState(0)
        video = os.path.join(root, "in")
        os.makedirs(video)
        for i in range(PARITY_FRAMES):
            Image.fromarray(rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)).save(
                os.path.join(video, f"{i:03d}.png"))
        config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                              "toonyou.yaml")
        common = [video, config, "--tiny", "--seed", "7"]
        first = parity.run(parity.build_argparser().parse_args(
            common + ["--output", os.path.join(root, "ours")]))
        again = parity.run(parity.build_argparser().parse_args(
            common + ["--reference", os.path.join(root, "ours")]))
        if again["value"] != float("inf") or not again["scored_frames"] == first["frames"] == 3:
            raise AssertionError(f"parity: a self-comparison gave {again}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds["parity"] = time.perf_counter() - t0
    return dict(trace=traced, stages=stages, parity=again, seconds=seconds)


def phase_17(torch, main_keep, main_path, smi) -> None:
    """Phase 17 and its report: ``start_phase``, then ``tools_phase``."""
    t_phase = time.perf_counter()
    started = start_phase(torch)
    t_started = time.perf_counter() - t_phase
    for mode in ("cold", "warm"):
        r = started[mode]
        print(f"{mode} start: {json.dumps(r)}")
        print(f"{mode} start: build {r['build_s']:.3f} s, aot load {r['aot_load_s']:.3f} s, "
              f"prepare {r['prepare_s']:.3f} s, first step {r['first_step_s']:.3f} s, process "
              f"start to first frame {r['to_first_frame_s']:.3f} s, in _build.build (nvcc) "
              f"{r['nvcc_s']:.3f} s ({smi})")
    print(f"warm first frame bit-equal to the cold one; a tampered library refused and kept: "
          f"{started['warm']['tampered']['reason']}")
    tooled = tools_phase(torch, main_keep, main_path)
    traced, gaps = tooled["trace"], tooled["trace"]["gaps"]
    print("trace_step: " + json.dumps({k: traced[k] for k in (
        "kernels", "kernels_by_frame", "unassigned", "device_ms", "buckets", "gaps")}))
    print(f"trace_step top kernels: {json.dumps(traced['top'])}")
    print(f"trace_step families: {json.dumps(traced['families'])}")
    print(f"trace_step: {traced['kernels_full']} kernels a step (by frame "
          f"{traced['kernels_by_frame']}, by correlation id; dropped from the trace "
          f"{json.dumps(traced['dropped_by_frame'])}) and {traced['device_ms']:.3f} "
          f"device ms a frame (x{traced['device_ms_over_phase_4']:.4f} phase 4's profile); "
          f"frame p50 {gaps['wall_ms_p50']:.3f} ms = the replay's device span "
          f"{gaps['span_ms_p50']:.3f} (busy {gaps['busy_ms_p50']:.3f}, idle inside "
          f"{gaps['idle_in_span_ms_p50']:.3f}) + host {gaps['host_ms']:.3f} (before the replay "
          f"{gaps['before_replay_ms_p50']:.3f}); the replay's host time (the graph's launch) "
          f"{gaps['launch_ms_p50']:.3f}; the span under the profiler "
          f"{gaps['profiled_span_ms_p50']:.3f} ({smi})")
    print(f"profile_stages on phase 4's stream, ms: {json.dumps(tooled['stages'])} ({smi})")
    print(f"parity, --tiny on the card against its own output: {json.dumps(tooled['parity'])}")
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s, the two starts "
          f"{t_started:.1f} s of it; the tools: {json.dumps(tooled['seconds'])}")


# ---------------------------------------------------------------------------
# phase 18: tensor and data parallelism, two gloo ranks on the one card
# ---------------------------------------------------------------------------

TP_WORLD = 2
TP_TAG = "TP_RESULT "
TP_TIMEOUT_S = 400
TP_PER_RANK = (2, 4, 8)  # the tp of the per-rank kernel shapes (a)
# (b) the full-width stream step at tp = 2: bench.py's 512x512 (latent 64),
# 2 steps, bf16, int8 cache; the warmup, then 8 frames through the window
TP_STREAM = dict(latent=64, steps=2, frames=8, text_len=77)
# relative RMS of a frame against the unsharded step: the row-parallel sums
# round to bf16 once more a block (partials, then their sum)
TP_RMS_TOL = 1e-2
# each rank's launches a stream step: #1 at every temporal attention, #3 at
# the UNet's spatial attentions (phase 4's 44 less the ViT's 12), nothing else
TP_STEP_LAUNCHES = {"stream_attention_int8": 40, "flash_attention": 32}
# (c) the train step at tp = 2 at phase 16's widths (256x256, batch 2, clip
# 4, fp32, TF32 off), every weight drawn (the zero-initialised output
# projections too, so every motion gradient is nonzero), against one
# process on the same card, after each of 3 steps
TP_TRAIN_STEPS = 3
TP_LOSS_TOL, TP_GRAD_TOL = 1e-5, 1e-4
# (d) 4 sessions over dp = 2 (2 a rank, no collective) against one process
# with 4: phase 14's pipeline without depth, phase 14's bounds (the batched
# step at another batch rounds otherwise in bf16)
TP_SESSIONS, TP_SESSION_ROUNDS = 4, 4


def per_rank_kernel_rows(torch, gen, dev, kernels, train_shapes) -> dict:
    """Phase 18 (a): #1 (int8 and bf16 cache) and #3 (d-major, and the fp32
    training pair) against their plain versions at each tp rank's shapes of
    the full-width UNet for tp in TP_PER_RANK: C/tp channels of 8/tp motion
    heads, 8/tp spatial heads, the training step's shapes (phase 16) at
    8/tp heads. The rows join their kernel's entry (``tp_rows``); each is
    printed beside the tp = 1 row of its shape."""
    by_name = {k["name"]: k for k in kernels}
    out = {}
    for name, check in (
            ("stream_attention_int8",
             lambda tp: check_stream_attention(torch, gen, dev, "int8", tp)),
            ("stream_attention_bf16",
             lambda tp: check_stream_attention(torch, gen, dev, "bf16", tp)),
            ("flash_attention", lambda tp: check_flash(torch, gen, dev, tp))):
        rows = [r for tp in TP_PER_RANK for r in check(tp)]
        by_name[name]["tp_rows"] = rows
        out[name] = rows
    for tp in TP_PER_RANK:
        shapes = {(q[:2] + (q[2] // tp,) + q[3:], k[:2] + (k[2] // tp,) + k[3:], scale): calls
                  for (q, k, scale), calls in train_shapes.items()}
        fwd, bwd = check_train_attention(torch, gen, dev, shapes)
        for name, rows in (("flash_train_fwd", fwd), ("flash_train_bwd", bwd)):
            for r in rows:
                r["tp"] = tp
            by_name[name].setdefault("tp_rows", []).extend(rows)
            out.setdefault(name, []).extend(rows)
    for k in by_name.values():  # a rank's step at each tp: sum over shapes of calls x ms
        if "tp_rows" in k:
            k["tp_totals"] = {str(tp): {key: (None if any(r[key] is None for r in rows)
                                             else sum(r["calls"] * r[key] for r in rows))
                                        for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
                              for tp in TP_PER_RANK
                              for rows in [[r for r in k["tp_rows"] if r["tp"] == tp]]}
    return out


def print_per_rank_rows(kernels, smi) -> None:
    """Each per-rank row beside its tp = 1 row (the same level or call)."""
    def key(name, r):
        shape = r["shape"].split(" heads")[0]
        if name.startswith("stream"):  # q[s,hw,c]: the level's HW
            return shape.split(",")[1]
        dims = [int(x) for x in re.findall(r"\d+", shape.split("scale")[0])]
        return dims[0], dims[1], dims[5]  # q[b,sq,h,d] k[b,sk,h,d]: b, sq, sk

    for k in kernels:
        if "tp_rows" not in k:
            continue
        base = {key(k["name"], r): r for r in k["shapes"]}
        for r in k["tp_rows"]:
            one = base.get(key(k["name"], r))
            route = f" route ({r['route']})" if "route" in r else ""
            print(f"{k['name']:22s} tp {r['tp']} {r['shape']:56s}{route} rel {r['rel_err']:.2e} "
                  f"ms {r['ms']:.4f} (tp 1: {one['ms'] if one else None}) plain "
                  f"{r['plain_ms']:.3f} bound {r['bound_ms']:.4f} ({r['bound_by']}) library "
                  f"{r['library_ms']} calls {r['calls']}")
        print(f"{k['name']:22s} a rank's {k.get('per_what', 'stream step')} by tp: "
              f"{json.dumps(k['tp_totals'])}; tp 1 {k['ms']:.4f} ms ({smi})")


# the control beside (b): the unsharded step against itself with 1 % of
# the warmup latents' elements moved by 2^-7 of their value (one bf16 ulp
# or two): what a perturbation far below bf16's rounding does to the
# outputs over the UNet's depth, the scale on which (b)'s error reads
TP_NUDGE_SHARE, TP_NUDGE = 0.01, 2.0 ** -7


def nudged_stream_control(torch, config) -> dict:
    """The unsharded stream of (b), on its inputs and on nudged ones: each
    frame's relative RMS and the int8 codes that differ."""
    from live2diff_tpu_torch.parallel.infer import (
        compare_caches, random_unet, run_stream, stream_inputs,
    )

    dev = torch.device("cuda")
    unet = random_unet(config, 0, torch.bfloat16, dev)
    inputs = stream_inputs(config, TP_STREAM["latent"], TP_STREAM["steps"], TP_STREAM["frames"],
                           TP_STREAM["text_len"], 1, torch.bfloat16, dev)
    runs = []
    for nudge in (False, True):
        ins = dict(inputs)
        if nudge:
            gen = torch.Generator(device=dev).manual_seed(3)
            pick = torch.rand(ins["warm_sample"].shape, generator=gen, device=dev) < TP_NUDGE_SHARE
            ins["warm_sample"] = torch.where(pick, ins["warm_sample"] * (1 + TP_NUDGE),
                                             ins["warm_sample"])
        caches = config.init_caches(TP_STREAM["latent"], TP_STREAM["latent"], TP_STREAM["steps"],
                                    torch.int8, dev)
        runs.append(run_stream(unet, caches, ins)[:2])
    (ref, ref_caches), (out, caches) = runs
    return {"rel_rms": [rel_rms(o, r) for o, r in zip(out, ref)],
            "caches": compare_caches(caches, ref_caches)}


def tp_stream_part(torch, mesh) -> dict:
    """(b) on one rank: ``tp_stream_check`` of ``UNetConfig()`` at
    TP_STREAM, asserted."""
    from live2diff_tpu_torch.models.unet import UNetConfig
    from live2diff_tpu_torch.parallel.infer import tp_stream_check

    t0 = time.perf_counter()
    report = tp_stream_check(mesh, UNetConfig(), **TP_STREAM, device="cuda")
    report["seconds"] = time.perf_counter() - t0
    if mesh.rank == 0:
        report["control"] = nudged_stream_control(torch, UNetConfig())
    if not max(report["rel_rms"]) <= TP_RMS_TOL:
        raise AssertionError(f"tp stream: relative RMS {report['rel_rms']} over {TP_RMS_TOL}")
    if report["param_bytes_on_tp"] < 0.60:
        raise AssertionError(f"tp stream: {report['param_bytes_on_tp']:.3f} of the parameter "
                             "bytes on tp")
    if any(frame != TP_STEP_LAUNCHES for frame in report["launches"]):
        raise AssertionError(f"tp stream: launches a step {report['launches']}, expected "
                             f"{TP_STEP_LAUNCHES}")
    return report


def tp_train_part(torch, mesh) -> dict:
    """(c) on one rank: TP_TRAIN_STEPS steps at tp against one process (an
    unsharded twin in this process, stepped on the same batch and draws),
    the loss, every motion gradient (this rank's slab of the twin's), and
    the replicated motion parameters bit-equal across the tp ranks."""
    import torch.distributed as dist

    from live2diff_tpu_torch.models.unet import UNetConfig
    from live2diff_tpu_torch.parallel.infer import random_unet
    from live2diff_tpu_torch.parallel.mesh import Mesh
    from live2diff_tpu_torch.parallel.tp import shard_params, take_slab
    from live2diff_tpu_torch.parallel.train import (
        TrainState, is_motion_param, make_optimizer, make_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    config = UNetConfig(cond_mapping=False)  # the trainer's default: no depth branch
    lat = TRAIN_CONFIG["height"] // 8
    b, f = TRAIN_CONFIG["batch"], TRAIN_CONFIG["clip_len"]

    def state(unet):
        opt = make_optimizer(unet, TRAIN_CONFIG["lr"], TRAIN_CONFIG["weight_decay"])
        return TrainState(0, unet, opt, torch.Generator(device=dev).manual_seed(5))

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    unet = random_unet(config, 0, torch.float32, dev)
    layout = shard_params(unet, mesh)
    ours = state(unet)
    step = make_train_step(unet, ours.optimizer, mesh)
    torch.cuda.synchronize()
    sharded_bytes = torch.cuda.memory_allocated() - base
    twin = state(random_unet(config, 0, torch.float32, dev))
    twin_step = make_train_step(twin.unet, twin.optimizer, Mesh())
    gen = torch.Generator(device=dev).manual_seed(7)
    batch = {"latents": torch.randn(b, f, lat, lat, 4, generator=gen, device=dev),
             "text": torch.randn(b, 77, config.cross_attention_dim, generator=gen, device=dev)}
    replicated = [n for n, p in unet.named_parameters()
                  if is_motion_param(n) and n not in layout.specs]
    out = {"loss": [], "loss_twin": [], "grad_err": [], "step_ms": [], "twin_step_ms": [],
           "replicated_params": len(replicated), "sharded_bytes": sharded_bytes}
    for _ in range(TP_TRAIN_STEPS):
        twin.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()  # both models, the twin's AdamW state
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ours, loss = step(ours, batch)
        loss = float(loss)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out.setdefault("step_peak_bytes_net", []).append(
            torch.cuda.max_memory_allocated() - resident)
        t0 = time.perf_counter()
        twin, twin_loss = twin_step(twin, batch)
        twin_loss = float(twin_loss)
        out["twin_step_ms"].append((time.perf_counter() - t0) * 1e3)
        if not abs(loss - twin_loss) <= TP_LOSS_TOL * abs(twin_loss):
            raise AssertionError(f"tp train: loss {loss} against one process's {twin_loss}")
        worst = 0.0
        params = dict(unet.named_parameters())
        for name, p in twin.unet.named_parameters():
            if not is_motion_param(name):
                continue
            ref = p.grad
            if name in layout.specs:
                ref = take_slab(ref, layout.specs[name], mesh.tp_rank, mesh.tp)
            err = float((params[name].grad - ref).abs().max() / p.grad.abs().max())
            if not err <= TP_GRAD_TOL:
                raise AssertionError(f"tp train: {name} gradient {err:.3e} of its max off")
            worst = max(worst, err)
        flat = torch.cat([params[n].detach().flatten() for n in replicated])
        theirs = flat.clone()
        dist.broadcast(theirs, src=mesh.dp_rank * mesh.tp, group=mesh.tp_group)
        if not torch.equal(flat, theirs):
            raise AssertionError("tp train: replicated motion parameters differ across tp ranks")
        out["loss"].append(loss)
        out["loss_twin"].append(twin_loss)
        out["grad_err"].append(worst)
    return out


def tp_rank_run(rank: str, port: str, out_dir: str) -> int:
    """One of phase 18's two ranks (a process of its own): gloo over
    localhost with CUDA tensors, (b) and (c) at (dp, tp) = (1, 2), (d) at
    (2, 1), then ``dryrun_multichip``. Prints ``TP_TAG`` and its results as
    JSON; (d)'s outputs go to ``out_dir``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    rank = int(rank)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=TP_WORLD, rank=rank)
    try:
        from live2diff_tpu_torch.parallel.infer import dryrun_multichip, multi_session_run
        from live2diff_tpu_torch.parallel.mesh import make_mesh

        tp_mesh, dp_mesh = make_mesh(), make_mesh(tp=1)

        assert (tp_mesh.dp, tp_mesh.tp, dp_mesh.dp, dp_mesh.tp) == (1, 2, 2, 1)
        result, seconds = {}, {}
        t0 = time.perf_counter()
        result["stream"] = tp_stream_part(torch, tp_mesh)
        seconds["stream"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        result["train"] = tp_train_part(torch, tp_mesh)
        seconds["train"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        sessions = multi_session_run(dp_mesh, TP_SESSIONS, TP_SESSION_ROUNDS, latent=64,
                                     device="cuda", config=BENCH_CONFIG, unet_overrides=None,
                                     output_uint8=True)
        np.savez(os.path.join(out_dir, f"sessions{rank}.npz"), **sessions)
        seconds["sessions"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        dryrun_multichip(tp_mesh)
        seconds["dryrun_multichip"] = time.perf_counter() - t0
        result["seconds"] = seconds
        result["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        print(TP_TAG + json.dumps(result), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def tp_phase(torch, gen, dev, kernels, train_shapes, smi) -> dict:
    """Phase 18: (a) here, then two ranks (``tp_rank_run``) for (b)-(d) and
    ``dryrun_multichip``, then (d)'s one-process reference here."""
    import shutil
    import socket
    import tempfile

    import numpy as np

    from live2diff_tpu_torch.parallel.infer import multi_session_run
    from live2diff_tpu_torch.parallel.mesh import Mesh

    t_phase = time.perf_counter()
    per_rank_kernel_rows(torch, gen, dev, kernels, train_shapes)
    print_per_rank_rows(kernels, smi)
    t_kernels = time.perf_counter() - t_phase
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="live2diff-tp-")
    try:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-rank",
                                   str(r), str(port), out_dir],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(TP_WORLD)]
        try:
            logs = [p.communicate(timeout=TP_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                p.kill()
        t_ranks = time.perf_counter() - t0
        results, failed = [], []
        for r, (p, (stdout, stderr)) in enumerate(zip(procs, logs)):
            line = next((ln for ln in stdout.splitlines() if ln.startswith(TP_TAG)), None)
            if p.returncode != 0 or line is None:
                failed.append(f"tp rank {r}: rc {p.returncode}\n{stdout[-3000:]}\n"
                              f"{stderr[-5000:]}")
                continue
            for ln in stdout.splitlines():
                if ln.startswith("dryrun_multichip"):
                    print(f"rank {r}: {ln}")
            results.append(json.loads(line[len(TP_TAG):]))
        if failed:
            raise AssertionError("\n".join(failed))
        t0 = time.perf_counter()
        one = multi_session_run(Mesh(), TP_SESSIONS, TP_SESSION_ROUNDS, latent=64, device="cuda",
                                config=BENCH_CONFIG, unet_overrides=None, output_uint8=True)
        t_one = time.perf_counter() - t0
        per = TP_SESSIONS // TP_WORLD
        sessions = []
        for r in range(TP_WORLD):
            got = np.load(os.path.join(out_dir, f"sessions{r}.npz"))
            mine = slice(r * per, (r + 1) * per)
            levels = int(np.abs(got["outputs"].astype(np.int16)
                                - one["outputs"][:, mine].astype(np.int16)).max())
            err = rel_rms(torch.from_numpy(got["x_t_buffer"]),
                          torch.from_numpy(one["x_t_buffer"][mine]))
            if got["outputs"].shape != (TP_SESSION_ROUNDS, per, 512, 512, 3) or \
                    levels > MULTI_UINT8_TOL or not err <= MULTI_RMS_TOL:
                raise AssertionError(f"dp sessions, rank {r}: outputs {got['outputs'].shape} "
                                     f"{levels} levels off, noised latents {err:.3e}")
            sessions.append({"max_levels_off": levels, "x_t_rel_rms": err})
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return {"ranks": results, "sessions": sessions,
            "seconds": {"kernels": t_kernels, "ranks": t_ranks, "sessions_one_process": t_one,
                        "phase": time.perf_counter() - t_phase}}


def report_tp_phase(tp, smi) -> None:
    for r, res in enumerate(tp["ranks"]):
        st, tr = res["stream"], res["train"]
        c = st["caches"]
        print(f"rank {r} stream (UNetConfig(), 512x512, 2 steps, bf16, int8 cache, eager: a "
              f"step with gloo collectives cannot be captured in a CUDA graph): relative RMS "
              f"a frame {st['rel_rms']}; largest error over largest value "
              f"{st['max_rel_err']}; cache slabs: {c['codes_differ_share']:.3e} of the codes "
              f"differ (at most by {c['max_code_diff']}), scales within "
              f"{c['scales_max_rel_err']:.2e}, dequantised relative RMS "
              f"{c['dequantised_rel_rms']:.3e}; {st['param_bytes_on_tp']:.4f} of the parameter "
              f"bytes on tp; launches a step {st['launches'][0]}")
        if "control" in st:
            print(f"control, unsharded, 1 % of the warmup latents moved by 2^-7: relative RMS "
                  f"a frame {st['control']['rel_rms']}, caches {st['control']['caches']}")
        print(f"rank {r} stream frame ms, tp 2 (two ranks on one card, eager): "
              f"{st['frame_ms']}; unsharded eager {st['unsharded_frame_ms']} ({smi})")
        print(f"rank {r} train (tp 2, 256x256, batch 2, clip 4, fp32, TF32 off): loss "
              f"{tr['loss']} against {tr['loss_twin']}; worst motion gradient off by "
              f"{tr['grad_err']} of its max; {tr['replicated_params']} replicated motion "
              f"parameters bit-equal across the tp ranks after each step")
        print(f"rank {r} train step ms {tr['step_ms']} (one process {tr['twin_step_ms']}; both "
              f"ranks share one card: not a speed figure); the sharded state "
              f"{tr['sharded_bytes'] / 2**30:.2f} GiB, a step's peak net of what is resident "
              f"{[round(x / 2**30, 3) for x in tr['step_peak_bytes_net']]} GiB; the rank's "
              f"peak {res['peak_memory_bytes'] / 2**30:.2f} GiB ({smi})")
        print(f"rank {r} seconds {json.dumps(res['seconds'])}")
    print(f"dp sessions ({TP_SESSIONS} over 2 ranks, {TP_SESSION_ROUNDS} rounds) against one "
          f"MultiStream of {TP_SESSIONS}: {json.dumps(tp['sessions'])}")
    print(f"phase 18: {json.dumps(tp['seconds'])}")


# ---------------------------------------------------------------------------
# phase 19: the port bench, and param_dtype at full width
# ---------------------------------------------------------------------------

BENCH_ARGS = ("--frames", "40", "--budget", "300")
# the second run reads the engine directory the first one primed; no row
BENCH_AGAIN_ARGS = ("--frames", "10", "--budget", "0")
BENCH_TIMEOUT_S = 480  # the budget, a last row's overrun past it, the start
# each optional row's keys in the bench's line (burst: --chain's default 10)
BENCH_ROWS = {
    "burst": ("fps_burst10", "burst10_frame_ms_p50"),
    "serving_window": ("serving_wall_fps", "serving_p50_fps"),
    "sessions": ("aggregate_fps_4sessions", "aggregate_device_fps_4sessions",
                 "round_ms_p50_4sessions_device", "wall_fps_4sessions"),
    "768x512": ("fps_mean_768x512", "fps_p50_768x512", "vs_baseline_768x512",
                "fps_burst_768x512"),
    "psnr": ("psnr_int8_vs_bf16", "snr_int8_vs_bf16", "output_std_int8_check", "psnr_frames"),
    "selftest": ("kernel_selftest", "kernel_selftest_worst_rel_err"),
}
PARAM_DTYPE_FRAMES = 20
# the fp32-parameter stream against bf16 parameters rounded from the same
# weights: only the norms' scales and biases (applied in fp32 as stored,
# not rounded) and the DPT's weight standardisation differ, which 20
# recursive frames carry on. On an H100 (700 W) the uint8 outputs read
# 2.1e-4 to 5.5e-4 a frame and the latents each step leaves 9.9e-5 to
# 1.04e-4; a sub-ulp nudge of the warmup latents moves the bf16 step about
# 4e-3 (PERF.md, the tp section). Each limit lies between its reading and
# that. With random weights the outputs are near-flat and see no change
# inside the UNet, so the control is read on the latents: the
# fp32-parameter pipeline with this GroupNorm bias set to 0 read 8.5e-3 to
# 8.7e-3 there (its outputs: 6.3e-4). Inner norms' biases move the latents
# by less than the sound reading (PERF.md §6, PR 16): the CPU tests hold
# each layer's semantics; this check holds the full-width path.
PARAM_DTYPE_RMS_TOL = 2e-3
PARAM_DTYPE_LATENT_TOL = 1e-3
PARAM_DTYPE_CONTROL = "conv_norm_out.bias"


def bench_run(extra, engine_dir: str) -> dict:
    """``python -m live2diff_tpu_torch.bench`` with ``extra`` from this
    checkout: its last JSON line, the hand kernels' launches a step of its
    512x512 pipeline (its first launches stage line) and its wall seconds."""
    from live2diff_tpu_torch.bench import LAUNCHES_TAG

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "live2diff_tpu_torch.bench", *extra,
                           "--engine-dir", engine_dir],
                          cwd=here, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"bench {' '.join(extra)}: rc {proc.returncode}, no result line"
                             f"\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    print(f"bench {' '.join(extra)} stage lines:\n{proc.stderr[-4000:]}")
    result = json.loads(lines[-1])
    if not str(result.get("metric", "")).startswith("fps_p50_512x512"):
        raise AssertionError(f"bench {' '.join(extra)}: no headline: {result}")
    failed = {k: v for k, v in result.items() if v is None or v == "error"}
    if failed:
        raise AssertionError(f"bench {' '.join(extra)}: rows failed: {failed}")
    tagged = [ln.split(LAUNCHES_TAG, 1)[1] for ln in proc.stderr.splitlines()
              if LAUNCHES_TAG in ln]
    return dict(result=result, seconds=seconds, launches=json.loads(tagged[0]))


def bench_phase(main_launches) -> dict:
    """Phase 19, first part: the bench with every row from an empty engine
    directory, which it primes; then a short run from that directory, which
    must load from it (``aot_hit``). Each run's step launches the hand
    kernels of phase 4's step, as often (``main_launches``)."""
    import shutil
    import tempfile

    engines = tempfile.mkdtemp(prefix="live2diff-bench-")
    try:
        first = bench_run(BENCH_ARGS, engines)
        r = first["result"]
        missing = {row: [k for k in keys if k not in r] for row, keys in BENCH_ROWS.items()}
        missing = {row: keys for row, keys in missing.items() if keys}
        if r["skipped_rows"] or missing:
            raise AssertionError(f"bench: rows skipped {r['skipped_rows']}, missing {missing}")
        if r["kernel_selftest"] != "pass":
            raise AssertionError(f"bench: kernel selftest {r['kernel_selftest']}")
        again = bench_run(BENCH_AGAIN_ARGS, engines)
        for run in (first, again):
            if run["launches"] != main_launches:
                raise AssertionError(f"bench: launches a step {run['launches']}, phase 4's "
                                     f"{main_launches}")
        if again["result"]["aot_hit"] is not True:
            raise AssertionError(f"bench again from {engines}: aot_hit "
                                 f"{again['result']['aot_hit']}")
        return dict(first=first, again=again)
    finally:
        shutil.rmtree(engines, ignore_errors=True)


def param_dtype_phase(torch, _build, control: str = PARAM_DTYPE_CONTROL) -> dict:
    """Phase 19, second part: bench.py's pipeline at full width with
    ``param_dtype=torch.float32`` (bf16 compute) against a twin holding the
    same weights rounded to bf16 (the default path): ``prepare`` and 20
    captured frames each from the same inputs; the relative RMS of each
    uint8 output and of the latents each step leaves (``x_t_buffer``), the
    hand kernels' launches a step (equal), all kernels a step by the
    profile, parameter bytes and peak memory. Then the control: the
    fp32-parameter pipeline with the UNet parameter ``control`` (a norm's
    bias) set to 0, the same 20 frames against the same twin.
    ``param_dtype_verdict`` holds the result to its limits."""
    from live2diff_tpu_torch.builder import build_pipeline

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    kw = dict(dtype=torch.bfloat16, kv_cache_dtype="int8", output_uint8=True, seed=0,
              device=dev)
    pipes = {"fp32 params": build_pipeline(BENCH_CONFIG, 512, 512, param_dtype=torch.float32,
                                           **kw),
             "bf16 params": build_pipeline(BENCH_CONFIG, 512, 512, **kw)}
    fp32, twin = pipes["fp32 params"], pipes["bf16 params"]
    with torch.no_grad():
        for a, b in ((fp32.unet, twin.unet), (fp32.vae, twin.vae),
                     (fp32.depth_model, twin.depth_model)):
            src = dict(a.named_parameters())
            for name, p in b.named_parameters():
                if src[name].dtype != torch.float32 or p.dtype != torch.bfloat16:
                    raise AssertionError(f"{name}: {src[name].dtype} and {p.dtype}")
                p.copy_(src[name])
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.randn(1, 77, 768, generator=gen, device=dev)
    warm = torch.rand(8, 512, 512, 3, generator=gen, device=dev) * 2 - 1
    frames = torch.randint(0, 256, (PARAM_DTYPE_FRAMES, 512, 512, 3), generator=gen,
                           device=dev, dtype=torch.uint8)

    def stream_frames(stream, state):
        outs, latents = [], []
        for f in frames:
            state, out = stream(state, f)
            outs.append(out)
            latents.append(state.x_t_buffer.clone())
        return state, outs, latents

    runs = {}
    for name, built in pipes.items():
        stream = built.stream
        models = [m for m in (built.unet, built.vae, built.depth_model) if m is not None]
        param_bytes = sum(p.numel() * p.element_size() for m in models for p in m.parameters())
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state, _ = stream.prepare(warm, prompt, seed=2)
        stream.warm_frame_step(torch.uint8)
        _build.reset_launch_counts()
        stream.capture_step(state, torch.uint8)  # the wrappers count one step here
        launches = {k: v for k, v in _build.launch_counts.items() if v}
        state, outs, latents = stream_frames(stream, state)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        prof = profile_steps(torch, stream, state, frames[:4])
        runs[name] = dict(outs=outs, latents=latents, launches=launches,
                          kernels_per_step=prof["kernels_per_call"],
                          device_ms_per_step=prof["device_ms_per_call"],
                          param_bytes=param_bytes, peak_bytes_net=peak)
        del state
        stream.release_graphs()
    with torch.no_grad():
        dict(fp32.unet.named_parameters())[control].zero_()
    state, control_outs, control_latents = stream_frames(
        fp32.stream, fp32.stream.prepare(warm, prompt, seed=2)[0])
    del state
    fp32.stream.release_graphs()
    a, b = runs["fp32 params"], runs["bf16 params"]
    for o in a["outs"]:
        if o.shape != (512, 512, 3) or o.dtype != torch.uint8:
            raise AssertionError(f"param_dtype=float32: output {tuple(o.shape)} {o.dtype}")
    result = dict(
        control=control,
        rel_rms=[rel_rms(x, y) for x, y in zip(a.pop("outs"), b["outs"])],
        latents_rel_rms=[rel_rms(x, y) for x, y in zip(a.pop("latents"), b["latents"])],
        control_rel_rms=[rel_rms(x, y) for x, y in zip(control_outs, b.pop("outs"))],
        control_latents_rel_rms=[rel_rms(x, y)
                                 for x, y in zip(control_latents, b.pop("latents"))],
        **runs)
    del pipes, fp32, twin, control_outs, control_latents
    gc.collect()
    torch.cuda.empty_cache()
    return result


def param_dtype_verdict(pd: dict) -> None:
    """Raises unless ``param_dtype_phase``'s result meets its limits: every
    frame of the fp32-parameter stream within ``PARAM_DTYPE_RMS_TOL`` of the
    twin in its outputs and ``PARAM_DTYPE_LATENT_TOL`` in its latents, the
    control's worst latents past that limit, the same hand-kernel launches
    a step, the twin's kernels a step within the main path's."""
    for key, tol in (("rel_rms", PARAM_DTYPE_RMS_TOL),
                     ("latents_rel_rms", PARAM_DTYPE_LATENT_TOL)):
        errs = pd[key]
        if not all(math.isfinite(e) for e in errs) or max(errs) > tol:
            raise AssertionError(f"param_dtype=float32 against bf16 parameters: {key} {errs}")
    if not max(pd["control_latents_rel_rms"]) > PARAM_DTYPE_LATENT_TOL:
        raise AssertionError(f"the limit {PARAM_DTYPE_LATENT_TOL} misses a dropped "
                             f"{pd['control']}: {pd['control_latents_rel_rms']}")
    if pd["fp32 params"]["launches"] != pd["bf16 params"]["launches"]:
        raise AssertionError(f"hand kernels a step differ: {pd}")
    twin_kernels = pd["bf16 params"]["kernels_per_step"]
    if isinstance(twin_kernels, float) and twin_kernels > MAIN_PATH_LAUNCHES_PER_STEP:
        raise AssertionError(f"the default path: {twin_kernels} kernels a step")


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
                                EXPECTED_PREPARE, keep=kept, kv_cache_dtype="int8")
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
    dev_main = result["device_kernels_per_step"]
    main_keep = list(kept[0])  # phase 4's stream, for phases 13, 14 and 17
    del result

    phase("bf16 cache at full width, no depth (--kv-cache bf16 --no-depth)")
    result_bf16, counts_bf16 = run_stream(
        torch, _build, BF16_FRAMES, EXPECTED_PER_STEP_BF16,
        {"stream_attention_int8": 0, "layer_norm": 0, **OPT_IN_OFF},
        kv_cache_dtype="bf16", use_depth=False)
    print(json.dumps({k: v for k, v in result_bf16.items() if k != "frame_ms_all"}))
    dev_bf16 = result_bf16["device_kernels_per_step"]
    del result_bf16

    phase("int8 QK at full width: bench.py's --spatial-qk int8 (flash_variant='int8')")
    result, counts_int8 = run_stream(
        torch, _build, INT8_QK_FRAMES,
        with_variant(EXPECTED_PER_STEP, "flash_attention_int8", GATED_PER_STEP),
        with_variant(EXPECTED_PREPARE, "flash_attention_int8", GATED_PREPARE),
        keep=kept, kv_cache_dtype="int8", flash_variant="int8")
    report_stream(result)
    print(f"beside phase 4: {json.dumps({'main path': main_path, 'int8 QK': headline(result)})}")
    dev_int8 = result["device_kernels_per_step"]
    del result

    phase("GroupNorm kernel at every site (gn_kernel_sites='all')")
    result, counts_gn = run_stream(torch, _build, GN_FRAMES, EXPECTED_PER_STEP, EXPECTED_PREPARE,
                                   record_gn=True, keep=kept,
                                   kv_cache_dtype="int8", gn_kernel_sites="all")
    gn_step, gn_prepare = result.pop("group_norm_shapes")
    report_stream(result)
    gn_per_step = counts_gn["group_norm"]
    print(f"group_norm launches: {gn_per_step} a step (one per "
          f"GroupNorm call meeting the kernel conditions), {sum(gn_prepare.values())} in prepare")
    # one device kernel a call, by the profile of the replays (run_stream
    # asserts it, taking another trace where one dropped a record); every
    # step call resident
    prof = result["profile"]
    print(f"profiled launches a stream step: {prof['kernels_per_call']} with the GroupNorm "
          f"kernel at every site, {main_path['kernels_per_step']} on the main path; "
          f"group_norm.cu kernels a step {result['device_kernels_per_step']['group_norm']}; "
          f"routes a step {json.dumps(result['group_norm_routes_per_step'])}")
    if result["group_norm_routes_per_step"]["streamed"]:
        raise AssertionError(f"GroupNorm: a stream step's call was not resident: "
                             f"{result['group_norm_routes_per_step']}")
    print(f"beside phase 4: {json.dumps({'main path': main_path, 'GN kernel': headline(result)})}")
    dev_gn = result["device_kernels_per_step"]
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
                           height=512, width=768, kv_cache_dtype="int8")
    report_stream(result)
    wide = headline(result)
    del result

    phase("768x512 s-major A/B: phase 8 with flash_variant='smajor'")
    result, counts_smajor = run_stream(
        torch, _build, SMAJOR_FRAMES,
        with_variant(EXPECTED_PER_STEP, "flash_attention_smajor", GATED_PER_STEP),
        with_variant(EXPECTED_PREPARE, "flash_attention_smajor", GATED_PREPARE),
        height=512, width=768, kv_cache_dtype="int8", flash_variant="smajor")
    report_stream(result)
    print(f"beside phase 8: {json.dumps({'d-major': wide, 's-major': headline(result)})}")
    dev_smajor = result["device_kernels_per_step"]
    del result

    phase("LayerNorm kernel at every site (ln_kernel_sites='all')")
    result, counts_ln = run_stream(torch, _build, LN_FRAMES, EXPECTED_PER_STEP, EXPECTED_PREPARE,
                                   record_ln=True, kv_cache_dtype="int8",
                                   ln_kernel_sites="all")
    ln_step, ln_prepare = result.pop("layer_norm_sites")
    by_site = Counter()
    for (site, _, c, _), k in ln_step.items():
        by_site[site, c] += k
    print(f"layer_norm launches: {counts_ln['layer_norm']} a step (one per "
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

    phase("captured step: CUDA graph replays against the eager step (bench.py's main path)")
    captured = captured_step_phase(torch, _build)
    print(json.dumps(captured))
    phase("captured step with a bf16 cache, no depth (phase 5's configuration)")
    captured_bf16 = captured_step_equality(torch, kv_cache_dtype="bf16", use_depth=False)
    print(json.dumps(captured_bf16))

    phase("ingest and wrapper at full width: StreamV2VWrapper from files (CLIP, tokenizer, "
          "motion module, DPT, TAESD, two LoRAs)")
    wrapped = wrapper_phase(torch, _build, smi)
    print(json.dumps({k: v for k, v in wrapped.items() if k != "frame_ms_all"}))
    print(f"frame ms all, wrapper and bare stream() in turns: {json.dumps(wrapped['frame_ms_all'])}")
    print(f"kernels a step: {wrapped['kernels_per_step_float32_frames']} with float32 frames "
          f"(the wrapper's graph), {main_path['kernels_per_step']} with uint8 frames (phase 4) "
          f"({smi})")
    if dev_main != wrapped["device_kernels_per_step"]:
        raise AssertionError(f"the wrapper's step launched {wrapped['device_kernels_per_step']}, "
                             f"phase 4's {dev_main}")

    phase("KL codec at full width: phase 4's configuration with use_tiny_vae=False "
          "(SD-1.5's AutoencoderKL)")
    kl, _ = kl_phase(torch, _build, main_keep)
    report_stream(kl)
    print(f"KL codec (encode of {kl['codec']['encode_batch']} frames, decode of 1): "
          f"{json.dumps(kl['codec'])}; TAESD's {json.dumps(kl['taesd_codec'])}; codec share "
          f"of the KL frame p50 {kl['codec_share_of_frame_p50']:.3f} ({smi})")
    print(f"beside phase 4: {json.dumps({'main path': main_path, 'KL codec': headline(kl)})}; "
          f"in turns: {json.dumps(kl['in_turns_with_phase_4'])} ({smi})")
    if dev_main != {**kl["device_kernels_per_step"], **{k: dev_main[k] for k in NO_TAESD}}:
        raise AssertionError(f"KL step kernels {kl['device_kernels_per_step']}, phase 4's "
                             f"{dev_main} but the TAESD convs")
    del kl

    phase("MultiStream at full width: phase 4's pipeline, S = 2 and 4, both graphs "
          "captured at construction")
    multi = multi_phase(torch, _build, main_keep, dev_main)
    for key, r in multi.items():
        print(f"MultiStream {key}: " + json.dumps({k: v for k, v in r.items() if k != "profile"}))
        print(f"MultiStream {key}: round p50 {r['round_ms_p50']:.2f} ms, "
              f"{r['aggregate_fps']:.2f} frames/s in all against "
              f"{r['single_stream_fps_in_turns']:.2f} for phase 4's single stream in turns "
              f"(x{r['aggregate_over_single']:.3f}), masked "
              f"round x{r['masked_over_plain']:.3f} the plain one, peak memory "
              f"{r['peak_memory_net_bytes'] / 2**30:.2f} GiB net ({smi})")

    phase("warm start and the tools at full width (phase 17, run before phase 15): a cold "
          "and a warm start of the bench-default wrapper, each in a process of its own; "
          "trace_step and profile_stages on phase 4's stream; parity's tiny self-comparison")
    phase_17(torch, main_keep, main_path, smi)
    del main_keep

    phase("demo server over localhost: serve/server.py --sessions 2 at 512x512, two "
          "WebSocket users")
    served = server_phase(torch)
    print(f"demo server: {json.dumps(served)} ({smi})")

    phase("training at full width: Trainer at the JAX trainer's defaults (256x256, batch 2, "
          "clip 4, fp32), the training kernels at every shape it gives them")
    trained, train_entries, train_shapes = training_phase(torch, _build, smi, gen, dev)
    print(json.dumps({k: v for k, v in trained.items() if k != "profile"}))
    print(f"training profile: {json.dumps(trained['profile'])}")
    for k in train_entries:
        print_rows(k)
        print(f"{k['name']} by route, per training step: {json.dumps(k['routes'])}; fp32-lane "
              f"bound {k['bound_fp32_lanes_ms']:.4f} ms")
    print(f"training: step p50 {trained['step_ms_p50']:.2f} ms, p90 "
          f"{trained['step_ms_p90']:.2f} ms, {trained['clips_per_s']:.3f} clips/s, device "
          f"{trained['profile']['device_ms_per_call']} ms a step, attention kernels "
          f"{trained['profile'].get('attention_share_of_device_ms')} of it, peak memory "
          f"{trained['peak_memory_bytes'] / 2**30:.2f} GiB, TF32 {json.dumps(trained['tf32'])} "
          f"({smi})")

    phase("tensor and data parallelism (phase 18): the kernels at each tp rank's shapes; two "
          "gloo ranks on this card: the full-width stream step and train step at tp = 2 "
          "against one process, sessions over dp = 2, dryrun_multichip")
    tp = tp_phase(torch, gen, dev, kernels + train_entries, train_shapes, smi)
    report_tp_phase(tp, smi)

    phase("the port bench (phase 19): python -m live2diff_tpu_torch.bench --frames 40 "
          "--budget 300 from an empty engine directory, then again from the directory it "
          "primed; param_dtype=float32 at full width")
    t0 = time.perf_counter()
    benched = bench_phase({k: v for k, v in counts.items() if v})
    first, again = benched["first"], benched["again"]
    print(json.dumps(first["result"]))
    print(json.dumps(again["result"]))
    r = first["result"]
    print(f"bench ({first['seconds']:.1f} s): fps_p50 {r['fps_p50']} (chain p50 "
          f"{r['chain_mean_ms_p50']} ms, mean {r['frame_ms_mean']} ms), beside phase 4's frame "
          f"p50 {main_path['frame_ms_p50']:.2f} ms; again from the primed directory "
          f"({again['seconds']:.1f} s): aot_hit {again['result']['aot_hit']}, aot_load_s "
          f"{again['result']['aot_load_s']}, build_s {again['result']['build_s']} "
          f"(first: {r['build_s']}) ({smi})")
    print(f"bench: hand kernels a step {json.dumps(first['launches'])} in both runs, as in "
          f"phase 4")
    pd = param_dtype_phase(torch, _build)

    def per_frame(key):
        return f"{json.dumps([round(e, 6) for e in pd[key]])} (max {max(pd[key]):.6f})"

    print(f"param_dtype=float32 (bf16 compute) against the same weights rounded to bf16, "
          f"relative RMS per frame: outputs {per_frame('rel_rms')}, at most "
          f"{PARAM_DTYPE_RMS_TOL}; latents {per_frame('latents_rel_rms')}, at most "
          f"{PARAM_DTYPE_LATENT_TOL}. Control, {pd['control']} dropped: outputs "
          f"{per_frame('control_rel_rms')}; latents {per_frame('control_latents_rel_rms')}, "
          f"more than {PARAM_DTYPE_LATENT_TOL}")
    for name in ("fp32 params", "bf16 params"):
        run = pd[name]
        print(f"{name}: hand kernels a step {json.dumps(run['launches'])}, kernels a step "
              f"{run['kernels_per_step']}, device ms a step {run['device_ms_per_step']}, "
              f"parameters {run['param_bytes'] / 2**30:.2f} GiB, peak "
              f"{run['peak_bytes_net'] / 2**30:.2f} GiB net of the start ({smi})")
    param_dtype_verdict(pd)
    print(f"phase 19: {time.perf_counter() - t0:.1f} s")

    # each kernel's launches come from the phase that runs it: the wrappers'
    # counts over that phase's stream (its capture: one step), and the
    # device kernels a step in the profile of its replays
    source_run = {"stream_attention_bf16": (counts_bf16, dev_bf16, 5),
                  "flash_attention_int8": (counts_int8, dev_int8, 6),
                  "group_norm": (counts_gn, dev_gn, 7),
                  "flash_attention_smajor": (counts_smajor, dev_smajor, 9)}
    for k in kernels:
        run_counts, dev_counts, ph = source_run.get(k["name"], (counts, dev_main, 4))
        k["launches"] = run_counts[k["name"]]
        k["launches_per_step"] = run_counts[k["name"]]
        k["device_launches_per_step"] = dev_counts[k["name"]]
        k["launches_phase"] = ph
        if not k["launches"] or not k["device_launches_per_step"]:
            raise AssertionError(f"{k['name']} was not launched on phase {ph}")
    # the training kernels' launches: phase 16's counted steps
    for k in train_entries:
        k["launches"] = trained["launches"][k["name"]]
        k["launches_per_step"] = k["launches"] / trained["steps"]
        k["launches_by_route"] = {r: trained["launches_by_route"][f"{k['name']}:{r}"]
                                  for r in TRAIN_ROUTES}
        k["device_launches_per_step"] = sum(trained["device_kernels_per_step"][f"{k['name']}:{r}"]
                                            for r in TRAIN_ROUTES)
        k["launches_phase"] = 16
        kernels.append(k)

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--start"]:  # a process of phase 17 (start_phase)
        sys.exit(start_run(*sys.argv[2:]))
    if sys.argv[1:2] == ["--tp-rank"]:  # a rank of phase 18 (tp_phase)
        sys.exit(tp_rank_run(*sys.argv[2:]))
    sys.exit(main())
