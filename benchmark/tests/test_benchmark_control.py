"""The check's control: the plain reference in float8 products, put in the
program's place, must read past the limits the program's runs pass.

On the host at a tiny width; on the card (marked ``cuda``) at each cell's
own size, over three seeds."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(REPO))

import bench_tiny_cell  # noqa: E402
from test_benchmark_harness import demo_limit, harness_of, run  # noqa: E402

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_float8_control_fails_where_the_program_passes(tmp_path, kv):
    root = bench_tiny_cell.make_root(tmp_path, bench_tiny_cell.tiny_config("bfloat16", kv),
                                     limit=demo_limit())
    h = harness_of(root)
    sound = run(root)
    assert sound["correct"]
    for seed in (11, 12, 13):
        numbers = h.control(root, "tiny-64", seed, torch.float8_e4m3fn, "cpu")
        assert numbers["frame_rms_max"] > demo_limit(), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    proc = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload", cell, "--seeds", "2147483001",
         "2147483002", "2147483003"], cwd=REPO, capture_output=True, text=True, timeout=3000)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 3 and all(line["fails"] for line in lines), lines
