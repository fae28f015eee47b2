"""Nothing the runner or the reference loads is JAX or the JAX package, and
the reference loads nothing of the program. Module names are compared by
their top-level name, whole: ``live2diff_tpu_torch`` is not
``live2diff_tpu``."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
BENCH = REPO / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "live2diff_tpu"}

# a tiny cell run through the runner's own code, then the loaded modules' top-level names
RUNNER = """
import json, sys, tempfile, time
from pathlib import Path
sys.path[:0] = [{here!r}, {repo!r}]
import bench_tiny_cell
root = bench_tiny_cell.make_root(Path(tempfile.mkdtemp()))
sys.path.insert(0, str(root / "benchmark"))
import harness, run
harness.run_cell(root, "tiny-64", 3, 0.5, True, "cpu", time.perf_counter(), log=lambda m: None)
print(json.dumps({{"found": run.forbidden_modules(),
                   "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

REFERENCE = """
import json, sys
sys.path[:0] = [{here!r}, {bench!r}]
import torch
import bench_tiny_cell
from reference import stream
cfg = bench_tiny_cell.tiny_config()
if {reference!r}:
    cfg["reference"] = {reference!r}
models = stream.build(cfg, "cpu")
for m in models.values():
    for p in m.parameters():
        torch.nn.init.normal_(p, 0.0, 0.05)
s = stream.RefStream(cfg, models, 64, 64, 1, "cpu")
s.prepare(torch.zeros(8, 64, 64, 3, dtype=torch.uint8), torch.zeros(1, 77, 768))
s.step(torch.zeros(64, 64, 3, dtype=torch.uint8))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(script: str) -> object:
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_runner_loads_no_jax_and_no_jax_package():
    out = loaded(RUNNER.format(here=str(HERE), repo=str(REPO)))
    assert out["found"] == []
    assert not FORBIDDEN & set(out["top"])
    assert "live2diff_tpu_torch" in out["top"]  # the program under test, not its JAX twin


@pytest.mark.parametrize("own_module", [False, True], ids=["models.py", "own_module"])
def test_reference_loads_nothing_of_the_program(tmp_path, own_module):
    """The default reference, and a configuration's own module (here a copy
    of models.py named by the configuration)."""
    reference = ""
    if own_module:
        reference = str(tmp_path / "own.py")
        shutil.copy(BENCH / "reference/models.py", reference)
    top = set(loaded(REFERENCE.format(here=str(HERE), bench=str(BENCH), reference=reference)))
    assert not (FORBIDDEN | {"live2diff_tpu_torch"}) & top


def test_forbidden_names_compare_whole(monkeypatch):
    sys.path.insert(0, str(BENCH))
    import run

    sys.path.pop(0)
    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "live2diff_tpu_torch_extra", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "live2diff_tpu.ops", object())
    assert run.forbidden_modules() == ["live2diff_tpu"]
