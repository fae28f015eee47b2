"""The control of a cell's check: the plain reference with its products in
a lower precision, put in the program's place.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--low float8_e4m3fn]

For each seed it makes the cell's inputs as a run does (weights, frames,
prompt embeddings), follows the cell's compared calls with the reference
in fp32 and again with every matrix product and convolution on operands
rounded to ``--low`` (the nearest precision below the configuration's
bf16), and prints the numbers a run's check compares, one JSON line a
seed. A sound check reads every seed's numbers above their limits. Runs on
the card (``--device cpu`` only for a rehearsal); the benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--low", default="float8_e4m3fn")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("[control] no CUDA device", file=sys.stderr)
        return 2
    low = getattr(torch, args.low)
    cell, _ = harness.find_cell(ROOT, args.workload)
    limits = cell.check["limits"]
    for seed in args.seeds:
        numbers = harness.control(ROOT, args.workload, seed, low, args.device)
        numbers.update(workload=args.workload, seed=seed, low=args.low,
                       fails=[k for k, lim in limits.items()
                              if lim is not None and numbers[k] > lim])
        print(json.dumps(numbers), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
