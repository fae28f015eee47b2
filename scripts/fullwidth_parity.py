#!/usr/bin/env python3
"""The port against the JAX package at production width, on the CPU.

    python3 scripts/fullwidth_parity.py [--only clip|taesd|dpt|unet|stream|tp ...]
        [--tiny] [--json OUT] [--spill-dir DIR] [--threads N]

Runs the items of ``tests/_torch_fullwidth.py`` in order (CLIP, TAESD,
DPT-hybrid, the UNet at a 64x64 latent, the whole stream, the tp step on two
gloo ranks), each with its readings against its tolerance and its control,
and exits 1 if any item has a fault (a reading over its tolerance that
fp32 rounding does not explain, or a control under it). Each item runs in a
process of its own. ``--tiny`` runs every item at the parity tests' widths
(minutes). At full width (about 27 minutes on 8 cores) the UNet item holds
about 19 GB at its peak and writes its reference caches (5.7 GiB) to a
temporary directory under ``--spill-dir`` (default: the system's); ``--json``
writes every report.
JAX runs on the CPU, whatever backend the environment names.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tests"))
sys.path.insert(0, os.path.dirname(HERE))


def run_each(items, args) -> list:
    """Each item in a process of its own (this script with ``--only``), so
    that nothing of one item outlives it: the stream item took 13 minutes
    alone and over 30 after the UNet item in the same process."""
    reports = []
    with tempfile.TemporaryDirectory() as tmp:
        for item in items:
            out = os.path.join(tmp, f"{item}.json")
            cmd = [sys.executable, os.path.abspath(__file__), "--only", item, "--json", out,
                   "--threads", str(args.threads)]
            cmd += ["--tiny"] * args.tiny
            cmd += ["--spill-dir", args.spill_dir] if args.spill_dir else []
            rc = subprocess.run(cmd).returncode
            if not os.path.exists(out):
                raise SystemExit(f"fullwidth_parity: item {item} ended with rc {rc} and no report")
            with open(out) as f:
                reports += json.load(f)["reports"]
    return reports


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--only", nargs="*", default=None, help="items to run, in their order")
    p.add_argument("--tiny", action="store_true", help="the parity tests' widths")
    p.add_argument("--json", default=None, help="write the reports here")
    p.add_argument("--spill-dir", default=None, help="where the UNet item spills its caches")
    p.add_argument("--threads", type=int, default=os.cpu_count(), help="torch threads")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    import _torch_fullwidth as fw

    items = [i for i in fw.ITEMS if args.only is None or i in args.only]
    unknown = set(args.only or ()) - set(fw.ITEMS)
    if unknown:
        p.error(f"unknown items {sorted(unknown)}; expected some of {fw.ITEMS}")
    t0 = time.perf_counter()
    if len(items) > 1:
        reports = run_each(items, args)
    else:
        torch.set_num_threads(args.threads)  # _torch_parity sets 2 for the tests
        reports = fw.run_items(items, tiny=args.tiny, spill_dir=args.spill_dir)
    total = time.perf_counter() - t0
    faults = {r["item"]: r["faults"] for r in reports if r["faults"]}
    print(f"fullwidth_parity{' --tiny' if args.tiny else ''}: {len(reports)} items in "
          f"{total:.1f} s; {'faults: ' + json.dumps(faults) if faults else 'no fault'}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"tiny": args.tiny, "seconds": total, "reports": reports}, f, indent=1)
    return 1 if faults else 0


if __name__ == "__main__":
    raise SystemExit(main())
