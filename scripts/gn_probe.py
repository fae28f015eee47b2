#!/usr/bin/env python3
"""Where the GroupNorm kernel's time goes, probed on one GPU.

    python3 scripts/gn_probe.py [--reps 100]

1. Phases of this tree's kernel (``csrc/group_norm.cu``): the script builds
   a copy that stamps ``%globaltimer`` (ns, one clock for every SM) on each
   CTA's thread 0 at its start, when its first tile has arrived, before and
   after the grid's meeting, when its sample's group statistics are merged,
   and at its end, and inside the statistics and the merge (after each pass
   and fold; after the merge's mean and its M2), each by ``clock64()``
   (cycles of the CTA's SM, since its start; ``%globaltimer`` at start and
   end gives the clock, and each CTA's start against the earliest), nothing
   else changed, and runs it once at each shape in
   three conditions: ``cold`` (the L2 overwritten just before, as
   ``chip_smoke.py`` times a kernel: code and data come from device
   memory), ``code in L2`` (overwritten, then a one-CTA call of the same
   kernel, then the call), ``warm`` (right after the same call). Prints,
   relative to the earliest CTA start, the mean and latest time of each
   stamp.
3. The size of each kernel instance's machine code (``cuobjdump -sass``).
4. Twice: a copy that runs the statistics of a CTA's first tile and the
   merge of its first sample one extra time just before the real ones,
   stamped after each, so that the same work is timed once with the
   instructions first fetched and once again right after.
2. Ablations, each timed by the kernel's own device time (torch.profiler)
   and by CUDA events around a call (as ``chip_smoke.py``), at the same
   shapes: the kernel; without the grid's meeting (a CTA barrier in its
   place: wrong output, only its time is read); the same launched without
   the cooperative attribute; and an empty body (the kernel returns at once)
   with the cooperative attribute and its shared memory, without the
   attribute, and without either.

Prints the card's name and power limit, then JSON lines.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

from probe_util import build_copies, card, cold_timer, device_timer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((1, 576, 256, "relu"), (2, 256, 1280, "none"), (2, 1024, 640, "none"),
          (2, 1024, 960, "silu"), (2, 4096, 320, "none"), (2, 4096, 640, "silu"),
          (8, 4096, 640, "silu"))
# clock64() stamps by their slot in a CTA's row of g_probe; slots 9 and 10
# hold %globaltimer (ns) at the start and the end, for the SM clock
STAMPS = {0: "start", 1: "first tile in", 6: "pass 1 summed", 15: "thread 0 folded",
          7: "group means folded",
          8: "pass 2 summed", 2: "before meeting", 3: "after meeting",
          11: "merge: mean", 12: "merge: M2", 4: "statistics merged",
          5: "end"}

START = "  extern __shared__ __align__(128) unsigned char smem[];\n"
STAMP_EDITS = (
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n"
     "__device__ unsigned long long g_probe[1024][16];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
     "  return t;\n}\n"
     "#define gtime() clock64()\n"
     'extern "C" int probe_read(unsigned long long* h) {\n'
     "  return (int)cudaMemcpyFromSymbol(h, g_probe, sizeof(g_probe));\n}\n"),
    (START, START + "  if (threadIdx.x == 0) g_probe[blockIdx.x][0] = gtime();\n"
     "  if (threadIdx.x == 0) g_probe[blockIdx.x][9] = (gtime)();\n"),
    ("  __syncthreads();\n"
     "  fold_groups(red, ly, C, G, [&](int g, float s) { gmean[g] = s * inv_n; });\n"
     "  __syncthreads();\n",
     "  __syncthreads();\n  if (threadIdx.x == 0) g_probe[blockIdx.x][6] = gtime();\n"
     "  fold_groups(red, ly, C, G, [&](int g, float s) { gmean[g] = s * inv_n; });\n"
     "  if (threadIdx.x == 0) g_probe[blockIdx.x][15] = gtime();\n"
     "  __syncthreads();\n  if (threadIdx.x == 0) g_probe[blockIdx.x][7] = gtime();\n"),
    ("  __syncthreads();  // the tile is read: its buffer may take the next copy\n",
     "  __syncthreads();  // the tile is read: its buffer may take the next copy\n"
     "  if (threadIdx.x == 0) g_probe[blockIdx.x][8] = gtime();\n"),
    ("    const float mean = group_sum(sum, L) * inv_n;\n",
     "    const float mean = group_sum(sum, L) * inv_n;\n"
     "    if (threadIdx.x == 0) g_probe[blockIdx.x][11] = gtime();\n"),
    ("    if (g < G && l == 0) stats[g] = make_float2(mean, rsqrtf(m2 * inv_n + eps));\n",
     "    if (threadIdx.x == 0) g_probe[blockIdx.x][12] = gtime();\n"
     "    if (g < G && l == 0) stats[g] = make_float2(mean, rsqrtf(m2 * inv_n + eps));\n"),
    ("    parity ^= 1u << (j % S);\n    tile_stats(",
     "    parity ^= 1u << (j % S);\n"
     "    if (threadIdx.x == 0 && j == 0) g_probe[blockIdx.x][1] = gtime();\n"
     "    tile_stats("),
    ("  cg::this_grid().sync();  // every tile's partials are written\n",
     "  if (threadIdx.x == 0) g_probe[blockIdx.x][2] = gtime();\n"
     "  cg::this_grid().sync();  // every tile's partials are written\n"
     "  if (threadIdx.x == 0) g_probe[blockIdx.x][3] = gtime();\n"),
    ("      __syncthreads();\n      sample = s;\n",
     "      __syncthreads();\n      sample = s;\n"
     "      if (threadIdx.x == 0 && j == m - 1) g_probe[blockIdx.x][4] = gtime();\n"),
    ("load_tile(x, t0 + j - S, T, cut, C, buf_addr(j), bar(j));\n  }\n",
     "load_tile(x, t0 + j - S, T, cut, C, buf_addr(j), bar(j));\n  }\n"
     "  if (threadIdx.x == 0) g_probe[blockIdx.x][5] = gtime();\n"
     "  if (threadIdx.x == 0) g_probe[blockIdx.x][10] = (gtime)();\n"),
)
# the statistics of the first tile and the merge of the first sample run an
# extra time just before their real run, each stamped (slots 13, 14) after
TWICE_EDITS = STAMP_EDITS + (
    ("    tile_stats(buf(j), cut.rows(ij), ly, C, G, k, work,",
     "    if (j == 0) {\n"
     "      tile_stats(buf(j), cut.rows(ij), ly, C, G, k, work, part + (size_t)sj * G * k + ij,\n"
     "                 [] {});\n"
     "      if (threadIdx.x == 0) g_probe[blockIdx.x][13] = gtime();\n"
     "    }\n"
     "    tile_stats(buf(j), cut.rows(ij), ly, C, G, k, work,"),
    ("      sample_stats(part, s, cut, G, ly.cg, inv_n, eps, stats);\n",
     "      if (j == m - 1) {\n"
     "        sample_stats(part, s, cut, G, ly.cg, inv_n, eps, stats);\n"
     "        __syncthreads();\n"
     "        if (threadIdx.x == 0) g_probe[blockIdx.x][14] = gtime();\n"
     "      }\n"
     "      sample_stats(part, s, cut, G, ly.cg, inv_n, eps, stats);\n"),
)
NO_MEETING = ("  cg::this_grid().sync();  // every tile's partials are written\n",
              "  __syncthreads();\n")
PLAIN_LAUNCH = ("  cfg.numAttrs = 1;\n", "  cfg.numAttrs = 0;\n")
EMPTY_BODY = (START, START + "  if (B > 0) return;\n")
NO_SMEM = ("  cfg.dynamicSmemBytes = (size_t)smem;\n", "  cfg.dynamicSmemBytes = 0;\n")
ABLATIONS = {
    "kernel": (),
    "no grid meeting": (NO_MEETING,),
    "no grid meeting, plain launch": (NO_MEETING, PLAIN_LAUNCH),
    "empty body, cooperative, its shared memory": (EMPTY_BODY,),
    "empty body, plain launch, its shared memory": (EMPTY_BODY, PLAIN_LAUNCH),
    "empty body, plain launch, no shared memory": (EMPTY_BODY, PLAIN_LAUNCH, NO_SMEM),
}


def entry(lib: ctypes.CDLL):
    fn = lib.group_norm
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def caller(torch, fn, b, t, c, act, gen):
    """A call of ``fn`` (a copy's ``group_norm``) on fresh inputs with the
    wrapper's plan, and its output tensor."""
    from live2diff_tpu_torch.ops import _build
    from live2diff_tpu_torch.ops.norm import _ACTS, gn_device_limits, group_norm_plan

    x = (torch.randn(b, t, c, generator=gen, device="cuda") * 3.0 + 2.0).to(torch.bfloat16)
    g = (1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
    bt = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
    plan = group_norm_plan(b, t, c, 32, *gn_device_limits(0))
    part = torch.empty(b * plan.tiles_per_sample * 32 * 2, device="cuda")  # (mean, M2)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        _build.check(fn(x.data_ptr(), g.data_ptr(), bt.data_ptr(), out.data_ptr(),
                        part.data_ptr(), b, t, c, 32, plan.tiles_per_sample,
                        plan.tiles_per_cta, plan.slots, plan.ctas, _ACTS[act], 1e-5, stream),
                     "group_norm probe")

    return call, plan, (x, g, bt, out)


def stamps(torch, out_dir: str):
    """Per-phase globaltimer stamps of one cold call at each shape."""
    import numpy as np

    from live2diff_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, "group_norm.cu")) as f:
        text = f.read()
    lib = build_copies(text, {"stamps": STAMP_EDITS}, out_dir, "group_norm_stamps")["stamps"]
    fn = entry(lib)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    counters = np.zeros((1024, 16), dtype=np.uint64)
    rows = []
    for b, t, c, act in SHAPES:
        call, plan, _ = caller(torch, fn, b, t, c, act, gen)
        tiny, _, _ = caller(torch, fn, 1, 1, 256, act, gen)
        call()
        for mode, before in (("cold", lambda: flush.fill_(1)),
                             ("code in L2", lambda: (flush.fill_(1), tiny())),  # noqa: B023
                             ("warm", call)):
            before()
            call()
            torch.cuda.synchronize()
            lib.probe_read(counters.ctypes.data_as(ctypes.c_void_p))
            cnt = counters[:plan.ctas].astype(np.float64)
            mhz = (cnt[:, 5] - cnt[:, 0]) / (cnt[:, 10] - cnt[:, 9]) * 1e3
            # each CTA's cycles since its own start, in us at its clock; the
            # start as the globaltimer's offset from the earliest CTA's
            st = (cnt[:, list(STAMPS)] - cnt[:, :1]) / mhz[:, None]
            st[:, 0] = (cnt[:, 9] - cnt[:, 9].min()) / 1e3
            row = dict(shape=f"x[{b},{t},{c}] {act}", mode=mode, ctas=plan.ctas,
                       route=plan.route, sm_clock_mhz=float(mhz.mean()),
                       mean_us=dict(zip(STAMPS.values(), st.mean(0).tolist())),
                       latest_us=dict(zip(STAMPS.values(), st.max(0).tolist())))
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def twice(torch, out_dir: str):
    """The statistics of one tile and the merge of one sample, each run
    twice in one launch: us of the first run and of the second (warm
    caches, the same work), per CTA, mean over CTAs, warm call."""
    import numpy as np

    from live2diff_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, "group_norm.cu")) as f:
        text = f.read()
    lib = build_copies(text, {"twice": TWICE_EDITS}, out_dir, "group_norm_twice")["twice"]
    fn = entry(lib)
    gen = torch.Generator(device="cuda").manual_seed(3)
    counters = np.zeros((1024, 16), dtype=np.uint64)
    rows = []
    for b, t, c, act in SHAPES:
        call, plan, _ = caller(torch, fn, b, t, c, act, gen)
        call()
        call()
        torch.cuda.synchronize()
        lib.probe_read(counters.ctypes.data_as(ctypes.c_void_p))
        cnt = counters[:plan.ctas].astype(np.float64)
        mhz = (cnt[:, 5] - cnt[:, 0]) / (cnt[:, 10] - cnt[:, 9]) * 1e3
        us = lambda a, b: float(((cnt[:, b] - cnt[:, a]) / mhz).mean())  # noqa: E731
        row = dict(shape=f"x[{b},{t},{c}] {act}",
                   statistics_first_us=us(1, 13), statistics_second_us=us(13, 8) + us(8, 2),
                   merge_first_us=us(3, 14), merge_second_us=us(14, 4))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def sass_sizes():
    """Machine instructions of each kernel instance of the built
    ``csrc/group_norm.cu``."""
    import re
    import subprocess

    from live2diff_tpu_torch.ops import _build

    dump = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"),
                           "-sass", _build.build(["group_norm"])["group_norm"]],
                          capture_output=True, text=True, check=True).stdout
    sizes, name = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            sizes[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            sizes[name] += 1
    print(json.dumps(dict(sass_instructions=sizes)), flush=True)
    return sizes


def ablations(torch, out_dir: str, reps: int):
    from live2diff_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, "group_norm.cu")) as f:
        text = f.read()
    fns = {name: entry(lib) for name, lib in build_copies(text, ABLATIONS, out_dir,
                                                          "group_norm").items()}
    events, device = cold_timer(torch, reps), device_timer(torch, reps)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for b, t, c, act in SHAPES:
        row = dict(shape=f"x[{b},{t},{c}] {act}")
        for name, fn in fns.items():
            call, _, _ = caller(torch, fn, b, t, c, act, gen)
            row[f"{name}, device us"] = device(call) * 1e3
            row[f"{name}, events us"] = events(call) * 1e3
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args()
    import torch

    from live2diff_tpu_torch.ops import _build

    smi = card()
    print(smi)
    out_dir = os.path.join(_build.BUILD_DIR, "gn_probe")
    result = dict(device=smi, sass_instructions=sass_sizes(), stamps=stamps(torch, out_dir),
                  twice=twice(torch, out_dir),
                  ablations=ablations(torch, out_dir, args.reps))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
