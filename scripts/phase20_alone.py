#!/usr/bin/env python3
"""``chip_smoke.py`` phase 20 alone, on one card.

    python3 scripts/phase20_alone.py [--json OUT]

Builds the kernels, then runs ``fullwidth_phase`` as the whole script does
after phase 19: bench.py's configuration with fan-in weights, bf16 with the
kernels on the card against fp32 with the plain versions on the host's CPU
(64x64 frames through the DPT-hybrid, then the UNet at 512x512, each block
of its last call alone), bf16's own sensitivity and the two controls. Prints
the phase's report, holds it to ``fullwidth_verdict`` and writes the whole
result to ``--json`` (about 4 minutes with the build).
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from live2diff_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--json", default=None)
    args = p.parse_args()
    t0 = time.perf_counter()
    _build.build(_build.SOURCES)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    result = cs.fullwidth_phase(torch, _build)
    cs.report_fullwidth(result, smi)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    cs.fullwidth_verdict(result)
    print("phase 20: pass")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
