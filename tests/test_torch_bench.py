"""The port bench (``live2diff_tpu_torch/bench.py``) on the CPU: bench.py's
flags and headline keys, the budget gate, SIGTERM, the burst key taken from
``--chain``, bench.py's PSNR arithmetic and the sessions-only invocation.
Each run is ``--tiny --device cpu`` (bench.py's tiny UNet at 64x64, fp32):
CPU times, not a device measurement. The card's rows run in
``chip_smoke.py`` phase 19."""

from __future__ import annotations

import ast
import json
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

from live2diff_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = [sys.executable, "-m", "live2diff_tpu_torch.bench", "--tiny", "--device", "cpu"]
# two CPU threads a run: the tier-1 workers share the host
ENV = dict(os.environ, OMP_NUM_THREADS="2")

# the headline's keys: bench.py's, and the card's line
HEADLINE_KEYS = {
    "metric", "value", "unit", "vs_baseline", "protocol", "frame_ms_mean", "chain_mean_ms_p50",
    "chain_mean_ms_std", "fps_mean", "fps_p50", "frames", "upload_ms", "fetch_ms",
    "fps_mean_with_io", "build_s", "prepare_s", "first_step_compile_s", "aot_hit", "aot_load_s",
    "skipped_rows", "device",
}


def _last_json(stdout: str) -> dict:
    lines = [line for line in stdout.splitlines() if line.startswith("{")]
    assert lines, f"no JSON line in the output:\n{stdout[-2000:]}"
    return json.loads(lines[-1])


def _run(*extra, timeout=600):
    proc = subprocess.run(TINY + list(extra), cwd=REPO, env=ENV, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return _last_json(proc.stdout)


def test_tiny_bench_with_no_budget_prints_the_headline():
    """The budget spent before it starts: every optional row is skipped and
    the headline still lands, rc 0, with every key of bench.py's headline."""
    out = _run("--frames", "4", "--chain", "2", "--warmup-iters", "1", "--budget", "0")
    assert out["metric"] == "fps_p50_64x64_2steps"
    assert out["value"] > 0 and out["frames"] == 4
    assert "burst" in out["skipped_rows"]
    assert HEADLINE_KEYS <= set(out), HEADLINE_KEYS - set(out)
    assert out["aot_hit"] is False and out["device"].startswith("cpu")
    assert out["vs_baseline"] == round(out["fps_p50"] / 16.43, 3)


def test_burst_key_follows_the_chain():
    out = _run("--frames", "4", "--chain", "4", "--warmup-iters", "1", "--budget", "1000")
    assert out["fps_burst4"] > 0 and out["burst4_frame_ms_p50"] > 0
    assert "fps_burst10" not in out and out["skipped_rows"] == []


def test_sessions_only_invocation():
    out = _run("--sessions", "2", "--in-flight", "2")
    assert out["metric"] == "aggregate_fps_p50_64x64_2steps_2sessions"
    assert out["protocol"] == "pipelined-rounds"
    for key in ("aggregate_fps_2sessions", "aggregate_device_fps_2sessions",
                "round_ms_p50_2sessions_device", "wall_fps_2sessions"):
        assert out[key] > 0, key


def test_phase_ok_gates_on_the_budget(monkeypatch):
    monkeypatch.setattr(bench, "_RESULT", {})
    monkeypatch.setattr(bench, "_BUDGET_S", 0)
    assert not bench.phase_ok("x", 10)
    assert bench._RESULT["skipped_rows"] == ["x"]
    monkeypatch.setattr(bench, "_BUDGET_S", 10**9)
    assert bench.phase_ok("y", 10)
    assert bench._RESULT["skipped_rows"] == ["x"]


def test_sigterm_handler_exits_0_with_a_headline_and_124_without(monkeypatch, capsys):
    monkeypatch.setattr(bench, "_RESULT", {"metric": "fps_p50_test", "value": 1.0})
    with pytest.raises(SystemExit) as e:
        bench._on_term(signal.SIGTERM, None)
    assert e.value.code == 0
    assert json.loads(capsys.readouterr().out.strip())["metric"] == "fps_p50_test"
    monkeypatch.setattr(bench, "_RESULT", {})
    with pytest.raises(SystemExit) as e:
        bench._on_term(signal.SIGTERM, None)
    assert e.value.code == 124


def test_importing_the_bench_installs_no_handler():
    code = ("import signal; before = signal.getsignal(signal.SIGTERM); "
            "import live2diff_tpu_torch.bench; assert signal.getsignal(signal.SIGTERM) is before")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def _start():
    return subprocess.Popen(TINY + ["--frames", "40", "--chain", "20", "--warmup-iters", "1",
                                    "--budget", "1000"],
                            cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_sigterm_before_the_headline_exits_124():
    proc = _start()
    try:
        for line in proc.stderr:
            if "SIGTERM handler installed" in line:
                break
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 124
    assert not [line for line in out.splitlines() if line.startswith("{")]


def test_sigterm_after_the_headline_exits_0_and_prints_it():
    proc = _start()
    try:
        for line in proc.stdout:
            if line.startswith("{"):
                break
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0
    assert _last_json(out)["metric"] == "fps_p50_64x64_2steps"


def test_flags_are_a_superset_of_bench_py_with_its_defaults():
    """bench.py's flags, read from ``bench.py --help`` and its parser's
    defaults (a subprocess, which imports no JAX before argparse exits),
    are the port bench's, with the same defaults. The flags ``--help``
    hides are ``orchestrate``'s plumbing between its processes, which the
    port does not have."""
    proc = subprocess.run([sys.executable, "bench.py", "--help"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    jax_flags = set(re.findall(r"(?<![\w-])(--[a-z0-9][a-z0-9-]*)", proc.stdout)) - {"--help"}
    assert len(jax_flags) >= 25
    code = ("import json, sys; sys.argv = ['bench.py']; import bench; "
            "a = vars(bench.parse_args()); "
            "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax')]; "
            "print(json.dumps(a))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    jax_defaults = json.loads(proc.stdout.strip().splitlines()[-1])

    help_text = subprocess.run(TINY[:3] + ["--help"], cwd=REPO, capture_output=True, text=True,
                               timeout=120).stdout
    parser_flags = set(re.findall(r"(?<![\w-])(--[a-z0-9][a-z0-9-]*)", help_text))
    assert jax_flags <= parser_flags, jax_flags - parser_flags
    ours = vars(bench.parse_args([]))
    shown = {f[2:].replace("-", "_") for f in jax_flags}
    assert shown <= set(jax_defaults), shown - set(jax_defaults)
    assert {k: ours[k] for k in shown} == {k: jax_defaults[k] for k in shown}
    assert ours["device"] == "cuda"


def _bench_py_functions(*names):
    """bench.py's module-level functions ``names``, compiled from its source
    alone (importing bench.py would install its SIGTERM handler here)."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    nodes = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert {n.name for n in nodes} == set(names)
    ns = {"np": np}
    exec(compile(ast.Module(body=nodes, type_ignores=[]), "bench.py", "exec"), ns)
    return [ns[n] for n in names]


def test_psnr_snr_is_bench_py_arithmetic():
    (ref,) = _bench_py_functions("psnr", "_psnr_snr")[1:]
    rs = np.random.RandomState(0)
    b = rs.randint(0, 256, (3, 8, 8, 3)).astype(np.uint8)
    for a in (np.clip(b.astype(int) + rs.randint(-3, 4, b.shape), 0, 255).astype(np.uint8),
              255 - b, b):
        assert bench._psnr_snr(a, b) == ref(a, b)
    assert bench._psnr_snr(b, b)[:2] == (float("inf"), float("inf"))
