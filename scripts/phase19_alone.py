#!/usr/bin/env python3
"""``chip_smoke.py`` phase 19 alone, on one card.

    python3 scripts/phase19_alone.py
    python3 scripts/phase19_alone.py --skip-bench \
        --controls mid_block.resnets.0.norm1.bias down_blocks.0.resnets.0.norm1.bias

Builds the kernels, then runs the phase's two parts as the whole script
does after phase 18: ``bench_phase`` (the port bench with every row from an
empty engine directory, then again from the directory it primed; the launches
a step held to the main path's, ``EXPECTED_PER_STEP``) and
``param_dtype_phase`` (``param_dtype=torch.float32`` at full width against
the same weights in bf16, then the dropped-bias control), held to its limits
by ``param_dtype_verdict``. Prints both runs' result lines and the
``param_dtype`` report (about 3 minutes with the build). ``--controls``
runs the ``param_dtype`` part again for each named UNet parameter dropped
in place of ``PARAM_DTYPE_CONTROL`` and prints its readings (what the
limits can see); ``--skip-bench`` leaves out the bench.
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
    p.add_argument("--skip-bench", action="store_true")
    p.add_argument("--controls", nargs="*", default=[])
    args = p.parse_args()
    t0 = time.perf_counter()
    _build.build(_build.SOURCES)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    if not args.skip_bench:
        t0 = time.perf_counter()
        benched = cs.bench_phase({k: v for k, v in cs.EXPECTED_PER_STEP.items() if v})
        for name in ("first", "again"):
            run = benched[name]
            print(name, run["seconds"], json.dumps(run["result"]), json.dumps(run["launches"]))
        print(f"bench phase {time.perf_counter() - t0:.1f} s", flush=True)
    results = {}
    for control in [cs.PARAM_DTYPE_CONTROL, *args.controls]:
        t0 = time.perf_counter()
        results[control] = pd = cs.param_dtype_phase(torch, _build, control)
        print(f"control {control}: " + json.dumps(
            {k: [min(v), max(v)] for k, v in pd.items() if k.endswith("rel_rms")}))
        print(json.dumps(pd))
        print(f"param_dtype phase {time.perf_counter() - t0:.1f} s", flush=True)
    cs.param_dtype_verdict(results[cs.PARAM_DTYPE_CONTROL])
    return 0


if __name__ == "__main__":
    sys.exit(main())
