#!/usr/bin/env python3
"""Where the fused 3x3 conv's time goes, probed on one GPU.

    python3 scripts/conv_probe.py [--old DIR] [--reps 200]

1. Stages of this tree's kernel (``csrc/conv3x3.cu``): the script builds a
   copy with ``clock64()`` counters added (and nothing else changed) and
   runs it once at each of the main path's large shapes. Per CTA it reads
   the cycles spent staging the weights, the producer's waits for a free
   stage, and for each consumer warpgroup the waits for a full stage and
   its turn on the tensor cores, the products (``ldmatrix`` and ``wgmma``)
   and the epilogue, summed over its jobs; printed as the mean over CTAs,
   in us at the card's max SM clock.
2. Ablations of this tree's kernel, timed as ``chip_smoke.py`` times it:
   copies with the ldmatrix gathers or the wgmma products taken out (their
   outputs are wrong; only their time is read), at the large shapes of
   the step, beside the kernel itself: what the products and the gathers
   add on top of the copies and the epilogue.
3. With ``--old DIR``, a checkout whose ``conv3x3.cu`` is the WMMA version
   of the kernel, which stages its weights in shared-memory order
   (neighbouring threads read ``w [Cout, Cin, 3, 3]`` 1,152 bytes apart):
   that source as it is and with its weight loop reordered to read ``w`` in
   its own memory order (the only change), and this tree's kernel, at
   ``[1, 8, 8, 64]`` (one output tile) and ``[1, 64, 64, 64]`` with bias,
   skip and ReLU, each timed two ways: CUDA events around one call with the
   L2 cache overwritten before it (as ``chip_smoke.py``), and the kernel's
   own device time from ``torch.profiler``.

Prints the card's name and power limit, then JSON lines.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

from probe_util import build_copies, card, cold_timer, max_sm_mhz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# anchors in csrc/conv3x3.cu and the counters added after (or before) each
STAGE_EDITS = (
    ('#include "flash_sm90.cuh"\n',
     '#include "flash_sm90.cuh"\n'
     "__device__ unsigned long long g_probe[1024][8];\n"
     'extern "C" int probe_read(unsigned long long* h) {\n'
     "  return (int)cudaMemcpyFromSymbol(h, g_probe, sizeof(g_probe));\n}\n"
     'extern "C" int probe_clear() {\n'
     "  static unsigned long long z[1024 * 8];\n"
     "  return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));\n}\n"),
    ("  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;\n",
     "  const long long t_start = clock64();\n"
     "  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;\n"),
    ("  __syncthreads();\n\n  if (warp >= kConsumerThreads / 32) {\n",
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0) g_probe[blockIdx.x][0] = clock64() - t_start;\n\n"
     "  if (warp >= kConsumerThreads / 32) {\n"),
    ("    mbar_wait(empty + 8 * s, ((j / NS) & 1) ^ 1);\n    int b, oy0, ox0;\n    tile_of(j, b, oy0, ox0);\n    mbar_expect_tx",
     "    const long long tw = clock64();\n"
     "    mbar_wait(empty + 8 * s, ((j / NS) & 1) ^ 1);\n"
     "    g_probe[blockIdx.x][1] += clock64() - tw;\n"
     "    int b, oy0, ox0;\n    tile_of(j, b, oy0, ox0);\n    mbar_expect_tx"),
    ("      mbar_wait(full + 8 * s, (j / NS) & 1);\n"
     "      named_sync(1 + wg, kConsumerThreads);  // this warpgroup's turn\n",
     "      const long long t0 = clock64();\n"
     "      mbar_wait(full + 8 * s, (j / NS) & 1);\n"
     "      named_sync(1 + wg, kConsumerThreads);  // this warpgroup's turn\n"
     "      const long long t1 = clock64();\n"),
    ("      if (lane == 0) mbar_arrive(empty + 8 * s);  // the producer may refill the stage\n",
     "      if (lane == 0) mbar_arrive(empty + 8 * s);  // the producer may refill the stage\n"
     "      const long long t2 = clock64();\n"),
    ("          *reinterpret_cast<uint32_t*>(out + ob[h] + 8 * g) = pack_bf16(v0, v1);\n"
     "        }\n      }\n",
     "          *reinterpret_cast<uint32_t*>(out + ob[h] + 8 * g) = pack_bf16(v0, v1);\n"
     "        }\n      }\n"
     "      if (w4 == 0 && lane == 0) {\n"
     "        g_probe[blockIdx.x][2 + 3 * wg] += t1 - t0;\n"
     "        g_probe[blockIdx.x][3 + 3 * wg] += t2 - t1;\n"
     "        g_probe[blockIdx.x][4 + 3 * wg] += clock64() - t2;\n"
     "      }\n"),
)
STAGES = ("weights staged", "producer waits for a free stage",
          "warpgroup 0 waits for a full stage and its turn", "warpgroup 0 products",
          "warpgroup 0 epilogue", "warpgroup 1 waits for a full stage and its turn",
          "warpgroup 1 products", "warpgroup 1 epilogue")
# (B, H, W, Cin, stride, skip and ReLU): the main path's large calls
STAGE_SHAPES = ((2, 512, 512, 64, 1, True), (1, 512, 512, 64, 1, True), (2, 256, 256, 64, 1, True),
                (2, 512, 512, 3, 1, False), (2, 512, 512, 64, 2, False))

# the A-fragment gather and the product in csrc/conv3x3.cu, and the
# stand-ins of the ablations (keeping the registers live, the loop intact)
GATHER = ("          ldsm_x4(a[tap & 1][kk], st + p * 128 + (((2 * kk + khalf) ^ (p & 7)) << 4));",
          "          for (int i = 0; i < 4; ++i) a[tap & 1][kk][i] = st + p + i;")
PRODUCT = ("          wgmma_rs_kmajor(acc, a[tap & 1][kk], sw128_desc(sW + tap * (COUT * 128) + kk * 32, "
           "16, 1024),\n                          tap > 0 || kk > 0);",
           "          acc[kk] += __uint_as_float(a[tap & 1][kk][0] ^ a[tap & 1][kk][3]);")
ABLATION_SHAPES = ((2, 512, 512, 64, 1, True), (2, 512, 512, 64, 1, False),
                   (2, 256, 256, 64, 1, True), (2, 512, 512, 64, 2, False))

ORIGINAL = "const int co = i % COUT, ci = (i / COUT) % cinp, tap = i / (COUT * cinp);"
SOURCE_ORDER = "const int tap = i % 9, ci = (i / 9) % cinp, co = i / (9 * cinp);"


def conv_entry(lib: ctypes.CDLL):
    fn = lib.conv3x3
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build_variants(old_src: str, out_dir: str):
    """The old source as it is and in source order, each built with the
    port's nvcc flags; returns {name: its C entry}."""
    with open(old_src) as f:
        text = f.read()
    libs = build_copies(text, {"shared-memory order": (),
                               "source order": ((ORIGINAL, SOURCE_ORDER),)}, out_dir, "wmma")
    return {name: conv_entry(lib) for name, lib in libs.items()}


def stage_breakdown(torch, out_dir: str, mhz: float):
    """Per-stage us of this tree's kernel at STAGE_SHAPES (see the docstring)."""
    import numpy as np

    from live2diff_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, "conv3x3.cu")) as f:
        text = f.read()
    lib = build_copies(text, {"stages": STAGE_EDITS}, out_dir, "conv3x3_stages")["stages"]
    fn = conv_entry(lib)
    counters = np.zeros((1024, 8), dtype=np.uint64)
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for b, h, w, cin, stride, fused in STAGE_SHAPES:
        ho, wo = h // stride, w // stride
        x = torch.randn(b, h, w, cin, generator=gen, device="cuda").to(torch.bfloat16)
        wt = (torch.randn(64, cin, 3, 3, generator=gen, device="cuda") / (9 * cin) ** 0.5
              ).to(torch.bfloat16)
        bias = torch.randn(64, generator=gen, device="cuda").to(torch.bfloat16)
        skip = (torch.randn(b, ho, wo, 64, generator=gen, device="cuda").to(torch.bfloat16)
                if fused else None)
        out = torch.empty(b, ho, wo, 64, device="cuda", dtype=torch.bfloat16)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            return fn(x.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                      None if skip is None else skip.data_ptr(), out.data_ptr(), b, h, w, cin,
                      64, stride, int(fused), stream)

        call()
        flush.fill_(1)
        lib.probe_clear()
        if call() != 0:
            raise RuntimeError("the instrumented kernel did not launch")
        torch.cuda.synchronize()
        lib.probe_read(counters.ctypes.data_as(ctypes.c_void_p))
        ctas = min(sms, b * -(-ho // 4) * -(-wo // 16))  # the kernel's grid: 4 x 16 tiles
        us = counters[:ctas].astype(np.float64).mean(0) / mhz
        row = dict(shape=f"x[{b},{h},{w},{cin}] stride {stride}" + (" +skip+relu" if fused else ""),
                   ctas=ctas, jobs_per_cta=b * -(-ho // 4) * -(-wo // 16) / ctas,
                   us_per_cta=dict(zip(STAGES, us.tolist())))
        rows.append(row)
        print(json.dumps(row), flush=True)
        del x, skip, out
    return rows


def ablations(torch, out_dir: str, time_ms):
    """ms per call of this tree's kernel and of its copies without the
    gathers or the products, at ABLATION_SHAPES."""
    from live2diff_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, "conv3x3.cu")) as f:
        text = f.read()
    libs = build_copies(text, {"kernel": (), "without the ldmatrix gathers": (GATHER,),
                               "without the wgmma products": (PRODUCT,)}, out_dir, "conv3x3")
    fns = {name: conv_entry(lib) for name, lib in libs.items()}
    gen = torch.Generator(device="cuda").manual_seed(2)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for b, h, w, cin, stride, fused in ABLATION_SHAPES:
        x = torch.randn(b, h, w, cin, generator=gen, device="cuda").to(torch.bfloat16)
        wt = (torch.randn(64, cin, 3, 3, generator=gen, device="cuda") / 24).to(torch.bfloat16)
        bias = torch.randn(64, generator=gen, device="cuda").to(torch.bfloat16)
        skip = (torch.randn(b, h // stride, w // stride, 64, generator=gen, device="cuda")
                .to(torch.bfloat16) if fused else None)
        out = torch.empty(b, h // stride, w // stride, 64, device="cuda", dtype=torch.bfloat16)
        row = dict(shape=f"x[{b},{h},{w},{cin}] stride {stride}" + (" +skip+relu" if fused else ""))
        for name, fn in fns.items():
            row[f"{name}, ms"] = time_ms(lambda: fn(  # noqa: B023
                x.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                None if skip is None else skip.data_ptr(), out.data_ptr(), b, h, w, cin, 64,
                stride, int(fused), stream))
        rows.append(row)
        print(json.dumps(row), flush=True)
        del x, skip, out
    return rows


def device_us(torch, fn, n: int = 50) -> float:
    """The mean device time of the kernels ``fn`` launches, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()) / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="a checkout holding the WMMA conv kernel")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    import torch

    from live2diff_tpu_torch.ops import _build
    from live2diff_tpu_torch.ops.conv import conv3x3, conv3x3_plain

    smi = card()
    print(smi)
    mhz = max_sm_mhz()
    out_dir = os.path.join(_build.BUILD_DIR, "conv_probe")
    stages = stage_breakdown(torch, out_dir, mhz)
    stream = torch.cuda.current_stream().cuda_stream
    time_ms = cold_timer(torch, args.reps)
    ablated = ablations(torch, out_dir, time_ms)
    result = dict(device=smi, clock_mhz=mhz, stages=stages, ablations=ablated)
    if not args.old:
        print(json.dumps(result))
        return 0
    old = build_variants(os.path.join(os.path.abspath(args.old), "live2diff_tpu_torch", "csrc",
                                      "conv3x3.cu"), out_dir)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for hw in (8, 64):
        x = torch.randn(1, hw, hw, 64, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn(64, 64, 3, 3, generator=gen, device="cuda") / 24).to(torch.bfloat16)
        bias = torch.randn(64, generator=gen, device="cuda").to(torch.bfloat16)
        skip = torch.randn(1, hw, hw, 64, generator=gen, device="cuda").to(torch.bfloat16)
        ref = conv3x3_plain(x, w, bias, skip, True)
        row = dict(shape=f"x[1,{hw},{hw},64] +skip+relu")
        for name, fn in old.items():
            out = torch.empty_like(skip)
            call = lambda: _build.check(fn(  # noqa: E731
                x.data_ptr(), w.data_ptr(), bias.data_ptr(), skip.data_ptr(), out.data_ptr(),
                1, hw, hw, 64, 64, 1, 1, stream), name)
            call()
            torch.cuda.synchronize()
            row[f"WMMA kernel, weights in {name}, rel err"] = (
                (out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
            row[f"WMMA kernel, weights in {name}, ms"] = time_ms(call)
            row[f"WMMA kernel, weights in {name}, device us"] = device_us(torch, call)
        this = lambda: conv3x3(x, w, bias, skip, True)  # noqa: E731
        row["this tree's kernel, ms"] = time_ms(this)
        row["this tree's kernel, device us"] = device_us(torch, this)
        rows.append(row)
        print(json.dumps(row))
    print(json.dumps(dict(**result, wmma_fixed_cost=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
