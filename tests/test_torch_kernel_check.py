"""``live2diff_tpu_torch/tools/kernel_check.py`` on the CPU: its plan of
checks against the JAX file's, its metric against the JAX ``_relerr``, and
its refusal to run where the wrappers run their plain versions. The checks
themselves run on the card (``chip_smoke.py`` phase 19 calls
``run_all(quick=True)``)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from live2diff_tpu_torch.ops import _build
from live2diff_tpu_torch.tools import kernel_check as kc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import kernel_check as jax_kc  # noqa: E402  (numpy at import; JAX inside run_all)

# the check names tools/kernel_check.py:42-200 writes, in its order
JAX_QUICK = ["flash_smajor", "flash_dmajor", "flash_int8", "stream_attn_bf16_c320_hw1024",
             "stream_attn_int8_c320_hw1024", "taesd_conv64", "taesd_conv64_s2",
             "group_norm_silu", "layer_norm_vit577"]
JAX_FULL = ["flash_smajor", "flash_dmajor", "flash_int8", "flash_dmajor_6144", "flash_int8_6144",
            "stream_attn_bf16_c320_hw4096", "stream_attn_int8_c320_hw4096",
            "stream_attn_bf16_c1280_hw256", "stream_attn_int8_c1280_hw256", "taesd_conv64",
            "taesd_conv64_s2", "group_norm_silu", "layer_norm_vit577"]


def test_the_checks_reach_all_nine_kernels_by_name():
    nine = {k for k in _build.launch_counts if not k.startswith("flash_train")}
    assert len(nine) == 9 and set(kc.KERNELS) == nine
    for quick in (True, False):
        assert {c.kernel for c in kc.plan(quick)} == nine


@pytest.mark.parametrize("quick,names", [(True, JAX_QUICK), (False, JAX_FULL)])
def test_the_plan_is_the_jax_files(quick, names):
    checks = kc.plan(quick)
    assert [c.name for c in checks] == names
    assert (kc.EXACT_TOL, kc.INT8_TOL) == (jax_kc.EXACT_TOL, jax_kc.INT8_TOL)
    for c in checks:
        assert c.tol == (kc.INT8_TOL if c.case == "int8" else kc.EXACT_TOL), c.name


def test_relerr_is_the_jax_metric():
    rs = np.random.RandomState(0)
    want = rs.randn(4, 33).astype(np.float32)
    for got in (want + 1e-3 * rs.randn(4, 33).astype(np.float32), want, np.zeros_like(want),
                -want, want * np.float32(1.5)):
        ours = kc._relerr(torch.from_numpy(got).bfloat16(), torch.from_numpy(want))
        ref = jax_kc._relerr(torch.from_numpy(got).bfloat16().float().numpy(), want)
        assert ours == ref
        assert kc._relerr(got, want) == jax_kc._relerr(got, want)


@pytest.mark.parametrize("check", kc.plan(quick=True), ids=lambda c: c.name)
def test_each_check_builds_its_inputs_at_its_shapes(check):
    """The inputs and the reference of each quick check, made on the CPU
    (where the wrapper runs its plain version: the error is the plain
    version's against the reference, no kernel is compared)."""
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen).to(dtype)

    got_fn, want = kc._CASES[check.case](check, rand)
    got = got_fn()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    assert kc._relerr(got, want) <= check.tol


def test_run_all_raises_on_the_cpu():
    with pytest.raises(RuntimeError):
        kc.run_all(quick=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            kc.run_all(quick=True)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is there: it would run")
def test_the_cli_exits_non_zero_without_a_card():
    proc = subprocess.run([sys.executable, "-m", "live2diff_tpu_torch.tools.kernel_check",
                           "--quick"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert not [line for line in proc.stdout.splitlines() if line.startswith("{")]
    assert "CUDA" in proc.stderr


def test_main_prints_one_json_line_and_fails_on_a_failed_check(monkeypatch, capsys):
    """The CLI's line and exit code, with ``run_all``'s result given."""
    ok = {"flash_smajor": {"max_rel_err": 0.001, "tol": kc.EXACT_TOL, "ok": True}, "pass": True}
    monkeypatch.setattr(kc, "run_all", lambda quick, device: ok)
    assert kc.main(["--quick"]) == 0
    line = json.loads(capsys.readouterr().out.strip())
    assert line["metric"] == "kernel_selftest" and line["pass"] is True
    bad = dict(ok, flash_smajor={"max_rel_err": 0.5, "tol": kc.EXACT_TOL, "ok": False},
               **{"pass": False})
    monkeypatch.setattr(kc, "run_all", lambda quick, device: bad)
    assert kc.main([]) == 1
