"""The port's measuring tools (live2diff_tpu_torch/tools/, utils/timing.py)
on the CPU, against the JAX package's where there is one.

* ``psnr`` against ``tools/psnr.py:psnr`` (loaded by path) on random uint8
  frames, and inf on equal frames.
* ``parity`` at ``--tiny --device cpu`` against its own earlier output: inf
  (8 warmup frames, the config's 4 steps' lag of 3, 3 outputs).
* ``aot_probe load`` runs once at ``--tiny --device cpu``; ``profile_trace``
  writes a Chrome trace.

``tests/test_torch_benchmark_counts.py`` holds the trace arithmetic that
``benchmark/`` reads (``benchmark/tracemath.py``).
"""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from live2diff_tpu_torch.tools import aot_probe, parity, psnr
from live2diff_tpu_torch.utils.timing import profile_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"_jax_tools_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_psnr_matches_jax():
    jax_psnr = _jax_tool("psnr").psnr
    rng = np.random.RandomState(0)
    for _ in range(4):
        a = rng.randint(0, 256, (3, 32, 48, 3)).astype(np.uint8)
        b = np.clip(a.astype(np.int16) + rng.randint(-9, 10, a.shape), 0, 255).astype(np.uint8)
        assert abs(psnr.psnr(a, b) - jax_psnr(a, b)) <= 1e-12
        assert abs(psnr.psnr(a, b, peak=1.0) - jax_psnr(a, b, peak=1.0)) <= 1e-12
    assert psnr.psnr(a, a) == float("inf") == jax_psnr(a, a)
    scored = psnr.score([a[0], a[1]], [a[0], b[1], b[2]])
    assert scored["frames"] == 2 and scored["value"] == float("inf")
    assert scored["per_frame_min"] == round(psnr.psnr(a[1], b[1]), 2)
    with pytest.raises(ValueError):
        psnr.score([], [a[0]])


def _frame_folder(path, n, seed=0):
    from PIL import Image

    path.mkdir()
    rng = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)).save(
            path / f"{i:03d}.png")
    return path


def test_parity_tiny_self_comparison_is_inf(tmp_path, capsys):
    pytest.importorskip("PIL")
    video = _frame_folder(tmp_path / "in", 14)
    config = os.path.join(REPO, "configs", "toonyou.yaml")  # 4 steps: a lag of 3
    out = tmp_path / "ours"  # no extension: a lossless PNG folder
    first = parity.run(parity.build_argparser().parse_args(
        [str(video), config, "--tiny", "--device", "cpu", "--seed", "7", "--output", str(out)]))
    assert first["frames"] == 3 and first["value"] is None and first["missing_artifacts"] > 0
    assert first["device"].startswith("cpu")
    second = parity.run(parity.build_argparser().parse_args(
        [str(video), config, "--tiny", "--device", "cpu", "--seed", "7",
         "--reference", str(out)]))
    assert second["scored_frames"] == 3 and second["value"] == float("inf")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["value"] == float("inf")
    with pytest.raises(SystemExit) as e:
        parity.run(parity.build_argparser().parse_args(
            [str(video), config, "--tiny", "--device", "cpu", "--require-weights"]))
    assert e.value.code == 3


# ---------------------------------------------------------------------------
# the tools end to end, tiny, on the CPU
# ---------------------------------------------------------------------------

def test_aot_probe_load_tiny_cpu(tmp_path, capsys):
    assert aot_probe.main(["load", "--tiny", "--device", "cpu",
                           "--engine-dir", str(tmp_path)]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["aot_hit"] is False and r["aot_load_s"] == 0.0
    assert r["total_to_first_frame_s"] >= r["prepare_s"] + r["first_step_s"] > 0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(None) as prof:
        assert prof is None
    with profile_trace(str(tmp_path / "t")) as prof:
        torch.ones(8).add_(1)
    (trace,) = os.listdir(tmp_path / "t")
    assert trace.endswith(".json") and "traceEvents" in json.load(open(tmp_path / "t" / trace))
