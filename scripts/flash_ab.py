#!/usr/bin/env python3
"""Per-call device time of the port's two bf16 flash entries, on one GPU.

    python3 scripts/flash_ab.py [--other DIR] [--reps 20] [--json PATH]

Times ``flash_attention`` (d-major, kernel #3) at every shape of the
512x512 stream step and of ``prepare`` that ``chip_smoke.py`` checks, and
``flash_self_attention`` (s-major, kernel #4) at its 512x512 and 768x512
shapes, with CUDA events, the L2 cache overwritten before each call. With
``--other DIR`` (another checkout of the repository, for example a parent
commit unpacked with ``git archive``) both trees are timed on the same card
in turns: this tree, the other, the other, this tree, each in a process of
its own that builds its own kernels. Prints one line per shape with the
mean of each tree's two turns, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (B, Sq, Sk, H, D) of the d-major entry: the stream step's self- and
# cross-attention at the four levels and the ViT, then prepare's shapes
DMAJOR = [
    (2, 4096, 4096, 8, 40), (2, 1024, 1024, 8, 80), (2, 256, 256, 8, 160), (2, 64, 64, 8, 160),
    (2, 4096, 77, 8, 40), (2, 1024, 77, 8, 80), (2, 256, 77, 8, 160), (2, 64, 77, 8, 160),
    (1, 577, 577, 12, 64), (8, 4096, 4096, 8, 40), (4096, 8, 8, 8, 40), (1024, 8, 8, 8, 80),
    (256, 8, 8, 8, 160), (64, 8, 8, 8, 160), (8, 577, 577, 12, 64),
]
# (B, S, D) of the s-major entry, H = 8, blocks (512, 1024)
SMAJOR = [(2, 4096, 40), (2, 1024, 80), (2, 6144, 40), (2, 1536, 80), (8, 6144, 40),
          (8, 1536, 80)]


def child(root: str, reps: int) -> None:
    """Time every shape with the port found under ``root``; print JSON."""
    # this checkout may be on the path (PYTHONPATH, the working directory)
    sys.path = [root] + [p for p in sys.path if os.path.abspath(p or ".") != ROOT]
    import torch

    from live2diff_tpu_torch.ops import flash_attention as fa

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def time_ms(fn):
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(reps):
            flush.fill_(1)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / reps

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, sq, sk, h, d in DMAJOR:
        q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(b, sk, h, d, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        rows.append(dict(entry="dmajor", shape=f"q[{b},{sq},{h},{d}] k[{b},{sk},{h},{d}]",
                         ms=time_ms(lambda: fa.flash_attention(q, k, v, d ** -0.5))))
    for b, s, d in SMAJOR:
        q, k, v = (torch.randn(b, s, 8, d, generator=gen, device="cuda").to(torch.bfloat16)
                   .transpose(1, 2) for _ in range(3))
        rows.append(dict(entry="smajor", shape=f"q[{b},8,{s},{d}] blocks (512, 1024)",
                         ms=time_ms(lambda: fa.flash_self_attention(q, k, v, d ** -0.5, 512,
                                                                     1024))))
    print(json.dumps(dict(port=os.path.dirname(fa.__file__), rows=rows)))


def run_child(root: str, reps: int):
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root,
                          "--reps", str(reps)], capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"timing {root} failed:\n{out.stdout}\n{out.stderr}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    if not res["port"].startswith(root + os.sep):
        raise RuntimeError(f"timing {root} imported the port from {res['port']}")
    return res["rows"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout of the repository, timed in turns")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", help="also write the rows to this file")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.reps)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    other = os.path.abspath(args.other) if args.other else None
    order = [ROOT] if not other else [ROOT, other, other, ROOT]
    runs = [(root, run_child(root, args.reps)) for root in order]
    table = []
    for i, row in enumerate(runs[0][1]):
        this = [r[i]["ms"] for root, r in runs if root == ROOT]
        entry = dict(entry=row["entry"], shape=row["shape"], ms=sum(this) / len(this),
                     ms_turns=this)
        if other:
            that = [r[i]["ms"] for root, r in runs if root != ROOT]
            entry.update(other_ms=sum(that) / len(that), other_ms_turns=that)
        table.append(entry)
        print(json.dumps(entry))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(device=smi, rows=table), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
