"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Builds the cell's system under test from its
configuration (weights, frames and prompt embeddings made from ``--seed``),
sets it up, streams for ``--seconds`` in a closed loop, then (``--trace 1``)
profiles a fixed number of calls, then checks the first compared outputs
against the plain fp32 reference. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer ones with ``--trace
1``), ``device``, ``breakdown`` (traced runs) and ``check``, each number
compared with its limit. The numbers compared also go to standard error,
last.

Exits 2 without a result when no CUDA device (or too few) is there, a
number from the host never being reported under a device metric's name, or
when the checkout holds no ``live2diff_tpu_torch``. Exits 3 without a
result when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time


def _process_start() -> float:
    """The ``perf_counter`` reading of this process's start: its age from
    ``/proc`` (the interpreter's own start-up included), or now."""
    now = time.perf_counter()
    try:
        import os

        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = _process_start()

import os  # noqa: E402

# one process, few threads: the host's libraries run single-threaded
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache the run writes, at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda_cache"}
FORBIDDEN = ("jax", "jaxlib", "flax", "live2diff_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``live2diff_tpu_torch`` is not ``live2diff_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    if not (ROOT / "live2diff_tpu_torch" / "__init__.py").is_file():
        print(f"[bench] no live2diff_tpu_torch in {ROOT}: the program under test is the "
              "checkout's own", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    import torch

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in spec["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"[bench] no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available. "
              "No result: the host does not stand in for the card.", file=sys.stderr)
        return 2

    import harness

    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_PROCESS,
                              log=lambda msg: print(msg, flush=True))
    found = forbidden_modules()
    if found:
        print(f"[bench] forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 3
    line = json.dumps(result)
    for name, c in result["check"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
