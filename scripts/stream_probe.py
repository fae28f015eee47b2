#!/usr/bin/env python3
"""Where stream window attention's time goes, probed on one GPU.

    python3 scripts/stream_probe.py [--reps 50]

Builds copies of this tree's ``csrc/stream_attention.cu``, each with one
text edit, and calls their int8 and bf16 entries directly at the four UNet
levels of the 512x512 stream step (2 steps, 8 heads), on the route
``ops/stream_attention.py:plan`` picks:

1. Phases: a copy with ``clock64()`` and ``%globaltimer`` reads added (and
   nothing else changed), run once per shape. Per CTA, read by thread 0:
   the cycles of its prologue (the first copies issued, the tables and the
   q tile), its K pass, the logits' meeting and softmax, its V pass and its
   epilogue; printed as the mean over CTAs in us at the card's max SM
   clock, with the span of the CTAs' start and end times (ns).
2. Ablations, timed as ``chip_smoke.py`` times a kernel (CUDA events, the L2
   overwritten before each call): the kernel as it is; without the K and V
   arithmetic (the copies, barriers and softmax only); with the TMA map's
   L2 promotion set to none or 128 bytes instead of 256; without the
   cache's TMA copies (each stage's mbarrier completed by a plain arrive;
   the arithmetic on whatever shared memory holds). Their outputs
   are wrong; only their time is read.

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

SRC = os.path.join(ROOT, "live2diff_tpu_torch", "csrc", "stream_attention.cu")
LEVELS = ((320, 4096), (640, 1024), (1280, 256), (1280, 64))
MAX_CTAS = 4096

# anchors in csrc/stream_attention.cu and what replaces each, per copy
PHASE_EDITS = (
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n"
     "__device__ unsigned long long g_probe[4096][8];\n"
     'extern "C" int probe_read(unsigned long long* h) {\n'
     "  return (int)cudaMemcpyFromSymbol(h, g_probe, sizeof(g_probe));\n}\n"
     "__device__ __forceinline__ unsigned long long gtimer() {\n"
     "  unsigned long long t;\n"
     '  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));\n  return t;\n}\n'),
    ("  const int tid = threadIdx.x, lane = tid % 32, g = tid / 32;\n",
     "  const unsigned long long t_ns = gtimer();\n"
     "  long long t_c = clock64();\n"
     "  const int cta = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);\n"
     "  auto mark = [&](int k) {\n"
     "    const long long now = clock64();\n"
     "    if (threadIdx.x == 0 && cta < 4096) g_probe[cta][k] = now - t_c;\n"
     "    t_c = now;\n  };\n"
     "  const int tid = threadIdx.x, lane = tid % 32, g = tid / 32;\n"),
    ("  float prob[kWindow][VPL];  // V pass: all slots x this lane's positions\n",
     "  float prob[kWindow][VPL];  // V pass: all slots x this lane's positions\n"
     "  __syncthreads();\n  mark(2);\n"),
    ("      if (j == nch - 1) {\n",
     "      if (j == nch - 1) {\n        __syncthreads();\n        mark(3);\n"),
    ("          for (int k = 0; k < VPL; ++k) prob[w][k] = pr[w * P + VPL * lane + k];\n      }\n",
     "          for (int k = 0; k < VPL; ++k) prob[w][k] = pr[w * P + VPL * lane + k];\n"
     "        __syncthreads();\n        mark(4);\n      }\n"),
    ("  __syncthreads();\n\n  // ---- the out tile",
     "  __syncthreads();\n  mark(5);\n\n  // ---- the out tile"),
    ("  if (cluster > 1) cg::this_cluster().sync();\n}\n",
     "  if (cluster > 1) cg::this_cluster().sync();\n"
     "  __syncthreads();\n  mark(6);\n"
     "  if (threadIdx.x == 0 && cta < 4096) {\n"
     "    g_probe[cta][0] = t_ns;\n    g_probe[cta][1] = gtimer();\n  }\n}\n"),
)
ABLATIONS = {
    "kernel": (),
    "no arithmetic": (
        ("      if (nc == kChunk) {\n", "      if (false) {\n"),
        ("        for (int cc = 0; cc < nc; ++cc) kstep(cc);\n",
         "        for (int cc = 0; cc < 0; ++cc) kstep(cc);\n"),
        ("    } else if (g < nc) {\n", "    } else if (g < 0) {\n"),
    ),
    "L2 promotion none": (
        ("CU_TENSOR_MAP_L2_PROMOTION_L2_256B", "CU_TENSOR_MAP_L2_PROMOTION_NONE"),
    ),
    "L2 promotion 128B": (
        ("CU_TENSOR_MAP_L2_PROMOTION_L2_256B", "CU_TENSOR_MAP_L2_PROMOTION_L2_128B"),
    ),
    "no copies": (
        ("        mbar_expect_tx(b, kStageBytes);\n"
         "        tma_load(smem_u32(st), &tmap, b, p0, ch0 + cb, 0, s * 2 + kv);\n",
         "        fsm90::mbar_arrive(b);\n"),
    ),
}
PHASES = ("prologue", "K pass", "meet + softmax", "V pass", "epilogue")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import torch

    from live2diff_tpu_torch.ops import _build
    from live2diff_tpu_torch.ops.stream_attention import plan

    if not torch.cuda.is_available():
        print("stream_probe: no CUDA device", file=sys.stderr)
        return 2
    print(card())
    mhz = max_sm_mhz()
    with open(SRC) as f:
        text = f.read()
    libs = build_copies(text, {"phases": PHASE_EDITS, **ABLATIONS},
                        os.path.join(_build.BUILD_DIR, "stream_probe"), "stream_attention")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    time_ms = cold_timer(torch, args.reps)
    gen = torch.Generator(device=dev).manual_seed(0)
    s, heads, w = 2, 8, 16
    for cache in ("int8", "bf16"):
        for c, hw in LEVELS:
            q = torch.randn(s, hw, c, generator=gen, device=dev).to(torch.bfloat16)
            extra = torch.randn(s, w, heads, hw, generator=gen, device=dev)
            extra[:, 9:] = float("-inf")
            pe_v = torch.randn(s, w, c, generator=gen, device=dev)
            out = torch.empty_like(q)
            if cache == "int8":
                data = torch.randint(-127, 128, (s, 2, w, c, hw), generator=gen, device=dev,
                                     dtype=torch.int8)
                scales = 0.002 + 0.02 * torch.rand(s, 2, w, c, generator=gen, device=dev)
                ptrs = [q, data, scales, extra, pe_v, out]
            else:
                data = torch.randn(s, 2, w, c, hw, generator=gen, device=dev).to(torch.bfloat16)
                ptrs = [q, data, extra, pe_v, out]
            staging, cluster = plan(s, hw, c, heads, data.element_size(), sms)
            stream = torch.cuda.current_stream().cuda_stream

            def call(lib):
                fn = getattr(lib, f"stream_attention_{cache}")
                fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 5
                               + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
                rc = fn(*[t.data_ptr() for t in ptrs], s, w, c, hw, heads, (c // heads) ** -0.5,
                        cluster, int(staging == "tma"), stream)
                if rc:
                    raise RuntimeError(f"launch failed: cudaError_t {rc}")

            row = dict(cache=cache, shape=f"q[{s},{hw},{c}]", route=f"{staging}, cluster {cluster}")
            row.update({f"{name} ms": time_ms(lambda: call(libs[name])) for name in ABLATIONS})
            call(libs["phases"])
            torch.cuda.synchronize()
            probe = (ctypes.c_ulonglong * (MAX_CTAS * 8))()
            libs["phases"].probe_read(probe)
            tiles = -(-hw // (128 // data.element_size()))
            ctas = min(MAX_CTAS, tiles * cluster * heads * s)
            rows = [probe[8 * i:8 * i + 8] for i in range(ctas)]
            row["ctas"] = ctas
            for k, name in enumerate(PHASES):
                row[f"{name} us"] = sum(r[2 + k] for r in rows) / ctas / mhz
            t0 = min(r[0] for r in rows)
            row["cta span ns"] = dict(first_end=min(r[1] for r in rows) - t0,
                                      last_start=max(r[0] for r in rows) - t0,
                                      last_end=max(r[1] for r in rows) - t0)
            print(json.dumps(row), flush=True)
            del data
    return 0


if __name__ == "__main__":
    sys.exit(main())
