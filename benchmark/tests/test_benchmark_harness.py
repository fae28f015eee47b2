"""The harness on the host at a tiny width: the cell found by name, cells,
configurations and metrics added as new files picked up, the check holding
the program to the reference and catching broken steps, and no result
without a card."""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(REPO))

import bench_tiny_cell  # noqa: E402


def demo_limit() -> float:
    """The frame limit the 512x512 demo cell holds its runs to."""
    check = json.loads((REPO / "benchmark/checks/demo-512-1stream.json").read_text())
    return check["limits"]["frame_rms_max"]


def harness_of(root: Path):
    """The harness module of the checkout at ``root``."""
    sys.path.insert(0, str(root / "benchmark"))
    try:
        import harness
    finally:
        sys.path.pop(0)
    return harness


def run(root: Path, traced: bool = False, cell: str = "tiny-64", seed: int = 2147483647):
    return harness_of(root).run_cell(root, cell, seed, 1.0, traced, "cpu", time.perf_counter(),
                                     log=lambda _msg: None)


def test_rehearsal_finds_added_files_and_passes_its_check(tmp_path):
    """A configuration, a traffic file, a check and a per-layer metric added
    as new files (and entries), nothing that was there edited: the run
    finds each by name, reports the new metric, and its check passes."""
    root = bench_tiny_cell.make_root(tmp_path, bench_tiny_cell.tiny_config("bfloat16", "bf16"),
                                     limit=demo_limit())
    (root / "benchmark/metrics/call_count.py").write_text(
        "def read(ctx):\n    return float(len(ctx.calls))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "call_count", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "device", "moves": "fps",
                              "workloads": ["tiny-64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    plain = run(root)
    assert plain["correct"] and plain["failed"] == 0 and plain["attempted"] > 0
    assert set(plain["rehearsal_metrics"]) == {"fps", "latency_ms_p95", "setup_s"}
    assert "metrics" not in plain  # host numbers never under a device metric's name
    assert list(plain)[-1] == "check"
    assert plain["check"]["frame_rms_max"]["value"] < demo_limit()
    traced = run(root, traced=True)
    assert traced["correct"]
    assert traced["rehearsal_metrics"]["call_count"]["value"] == 2.0
    assert {"device_idle_pct", "kernels_per_frame"} <= set(traced["rehearsal_metrics"])
    assert "mfu_pct" not in traced["rehearsal_metrics"]  # no peaks off the card
    assert len(traced["breakdown"]["device_ops"]) <= 10


def test_sessions_rehearsal(tmp_path):
    """Two sessions through one MultiStream, int8 cache, against the
    reference followed session by session."""
    root = bench_tiny_cell.make_root(tmp_path, bench_tiny_cell.tiny_config("float32", "int8"),
                                     limit=demo_limit(), sessions=2, compare_calls=6)
    result = run(root)
    assert result["correct"] and result["attempted"] % 2 == 0
    assert result["check"]["frame_rms_max"]["value"] < 0.5


# a configuration's reference module whose codec negates the decoded image
FLIPPED = '''
from . import models as base


class FlippedTAESD(base.TAESD):
    def decode(self, z):
        return -super().decode(z)


def models(cfg):
    out = base.models(cfg)
    out["vae"] = FlippedTAESD(cfg["taesd"])
    return out
'''


@pytest.mark.parametrize("module", ["copy", "flipped"])
def test_a_configuration_names_its_reference_module(tmp_path, module):
    """The tiny configuration names a reference module added as a new file
    under reference/: the weight fill, the reference and the check take
    its models. A copy of models.py reproduces the keyless reference's
    frames bit for bit and passes; a module whose decode negates the image
    reads incorrect."""
    cfg = dict(bench_tiny_cell.tiny_config(), reference=f"{module}.py")
    root = bench_tiny_cell.make_root(tmp_path, cfg, limit=demo_limit(), compare_calls=6)
    ref_dir = root / "benchmark/reference"
    if module == "copy":
        shutil.copy(ref_dir / "models.py", ref_dir / "copy.py")
    else:
        (ref_dir / "flipped.py").write_text(FLIPPED)
    h = harness_of(root)
    cell, _ = h.find_cell(root, "tiny-64")
    assert h.ref_stream.reference_module(cell.cfg).__file__ == str(ref_dir / f"{module}.py")
    result = run(root)
    assert result["failed"] == 0
    assert result["correct"] == (module == "copy"), result["check"]
    if module == "copy":
        seed = 5
        keyless = dataclasses.replace(cell, cfg=bench_tiny_cell.tiny_config())
        inputs = (*h.frames(cell, seed, "cpu"), h.prompts(cell, seed, "cpu"))
        hooked = h.reference_outputs(cell, seed, 4, "cpu", *inputs)
        plain = h.reference_outputs(keyless, seed, 4, "cpu", *inputs)
        assert all(torch.equal(a, b) for s in plain for a, b in zip(hooked[s], plain[s]))


def test_same_seed_same_inputs(tmp_path):
    root = bench_tiny_cell.make_root(tmp_path)
    h = harness_of(root)
    cell, _ = h.find_cell(root, "tiny-64")
    a, b = h.frames(cell, 7, "cpu"), h.frames(cell, 7, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    assert not np.array_equal(a[1][0], h.frames(cell, 8, "cpu")[1][0])
    assert torch.equal(h.prompts(cell, 3, "cpu")[0], h.prompts(cell, 3, "cpu")[0])


def test_no_card_no_result():
    """Without a CUDA device the runner exits non-zero and prints no result
    line, rather than measuring the host."""
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "demo-512-1stream", "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


# ---------------------------------------------------------------------------
# the timed path broken underneath: the check must read correct false
# ---------------------------------------------------------------------------


def _state_unchanged(monkeypatch):
    """Every step hands its state back as it found it."""
    from live2diff_tpu_torch.stream import pipeline
    from live2diff_tpu_torch.stream.graph import state_tensors

    step = pipeline.StreamDiffusionDepth._session_step

    def frozen(self, states, *args, **kwargs):
        saved = [t.clone() for t in state_tensors(states)]
        out = step(self, states, *args, **kwargs)
        for t, old in zip(state_tensors(states), saved):
            t.copy_(old)
        return out

    monkeypatch.setattr(pipeline.StreamDiffusionDepth, "_session_step", frozen)


def _half_batch(monkeypatch):
    """The UNet computes the first half of its step rows; the other rows
    take their mean."""
    from live2diff_tpu_torch.models import unet

    forward = unet.UNet3DConditionModel.forward

    def half(self, sample, *args, **kwargs):
        out, caches = forward(self, sample, *args, **kwargs)
        keep = max(1, out.shape[0] // 2)
        out = torch.cat([out[:keep], out[:keep].mean(0, keepdim=True).expand_as(out[keep:])])
        return out, caches

    monkeypatch.setattr(unet.UNet3DConditionModel, "forward", half)


def _answer_altered(monkeypatch):
    """One output frame, the fifth the stream decodes, comes out mirrored."""
    from live2diff_tpu_torch.stream import pipeline

    decode = pipeline.StreamDiffusionDepth._decode_latents
    count = [0]

    def altered(self, x0):
        img = decode(self, x0)
        count[0] += 1
        return img.flip(-2) if count[0] == 5 else img

    monkeypatch.setattr(pipeline.StreamDiffusionDepth, "_decode_latents", altered)


@pytest.mark.parametrize("sessions", [1, 2])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
def test_a_broken_step_reads_incorrect(tmp_path, monkeypatch, fault, sessions):
    """Through the wrapper and through a MultiStream. The exchange between
    chips, the fourth fault, has no place on one chip: every cell takes
    one."""
    root = bench_tiny_cell.make_root(tmp_path, limit=demo_limit(), sessions=sessions,
                                     compare_calls=6)
    fault(monkeypatch)
    result = run(root)
    assert result["failed"] == 0
    assert not result["correct"], result["check"]
