"""The full-width parity harness (``tests/_torch_fullwidth.py``) at tiny
widths, and what the full-width checks rest on.

* Items 1-5 of the harness (``scripts/fullwidth_parity.py --tiny``) and item
  6 (the tp step on two gloo ranks): every reading under its tolerance, every
  control above it (under an int8 cache the control is shown, not held).
* The GroupNorm fault the full-width DPT showed: the port's plain GroupNorm
  summed its statistics in order on the CPU, 5.1e-5 off at the DPT stem's
  73,728-element groups where the JAX package is 2e-7 off; now 1.4e-7.
* The plain attention's query blocks (above 2^24 logits) equal the dense
  version bit for bit.
* ``chip_smoke.py``'s fan-in refill (phase 20) on a tiny port UNet.
* ``config.dump_config`` against the JAX one on ``configs/``, and the port's
  ``aot_probe --spatial-qk --steps``.
"""

from __future__ import annotations

import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import _torch_fullwidth as fw
from live2diff_tpu import config as jconfig
from live2diff_tpu.ops import norm as jnorm
from live2diff_tpu_torch import config as tconfig
from live2diff_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from live2diff_tpu_torch.ops import flash_attention as tflash
from live2diff_tpu_torch.ops import norm as tnorm
from live2diff_tpu_torch.tools import aot_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_sound(rep: fw.Report) -> None:
    d = rep.as_dict()
    fw.print_report(d)
    assert d["readings"] and d["controls"], d
    assert not rep.over(), d["readings"]  # tiny widths need no rounding check
    assert not d["faults"], d["faults"]


@pytest.mark.parametrize("item", ["clip", "taesd", "dpt", "unet", "tp"])
def test_item_at_tiny_width(item):
    rep = fw.RUNNERS[item](tiny=True)
    if item == "tp":  # port only: the unsharded step is the reference, no control
        d = rep.as_dict()
        assert len(d["readings"]) == 2 and not d["faults"], d
        return
    _assert_sound(rep)


@pytest.mark.parametrize("run", fw.STREAM_RUNS,
                         ids=[f"{c}-{'depth' if d else 'nodepth'}" for c, d in fw.STREAM_RUNS])
def test_stream_at_tiny_width(run):
    rep = fw.item_stream(tiny=True, runs=(run,))
    cache, depth = run
    assert len(rep.readings) == 1 + fw.STREAM_FRAMES
    if cache == "fp32" and not depth:
        _assert_sound(rep)  # the control runs on the fp32 stream without depth
        return
    assert not rep.over() and not rep.faults and not rep.controls, rep.as_dict()
    if not depth:  # under an int8 cache the dropped bias is shown, not held
        (info,) = rep.infos.values()
        assert info["max_rel"] > fw.STREAM_FP32_TOL


def test_a_reading_over_its_tolerance_stands_only_as_rounding():
    """Over its tolerance, a reading stands when the port is within
    ROUNDING_SLACK of the JAX output's own distance from the fp64 result."""
    rep = fw.Report("x", tiny=True)
    for label in ("rounding", "fault"):
        rep.add(label, {"rel_rms": 3e-5, "max_rel": 3e-5}, fw.MODULE_TOL)
    rep.add("sound", {"rel_rms": 1e-6, "max_rel": 1e-6}, fw.MODULE_TOL)
    exact = {k: np.ones(4) for k in ("rounding", "fault")}
    ref = {k: v * (1 + 3e-5) for k, v in exact.items()}
    ours = {"rounding": exact["rounding"] * (1 - 3e-5), "fault": exact["fault"] * (1 + 1e-3)}
    fw.check_rounding(rep, ours, ref, lambda: exact, lambda: ref)
    assert sorted(rep.roundings) == ["fault", "rounding"]
    assert rep.faults == ["fault: 3.000e-05 > 1e-05"]


def test_pooled_draws_follow_the_fill_rule():
    shapes = {"params": {"a": {"kernel": jax.ShapeDtypeStruct((3, 3, 64, 32), jnp.float32),
                               "bias": jax.ShapeDtypeStruct((32,), jnp.float32)},
                         "n": {"scale": jax.ShapeDtypeStruct((4096,), jnp.float32)}}}
    one, two = fw.pooled_params_like(shapes, 3), fw.pooled_params_like(shapes, 3)
    other = fw.pooled_params_like(shapes, 4)
    k = one["params"]["a"]["kernel"]
    np.testing.assert_array_equal(k, two["params"]["a"]["kernel"])
    assert not np.array_equal(k, other["params"]["a"]["kernel"])
    assert k.dtype == np.float32 and abs(k.std() * np.sqrt(3 * 3 * 64) - 1) < 0.05
    scale = one["params"]["n"]["scale"]
    assert abs(scale.mean() - 1) < 0.01 and abs(scale.std() - 0.1) < 0.01
    # a leaf longer than the pool is the pool tiled from its offset
    long = fw._take(fw.POOL_SIZE + 10, np.random.default_rng(0))
    assert long.shape == (fw.POOL_SIZE + 10,) and np.isfinite(long).all()


@pytest.mark.parametrize("shape", [(1, 192 * 192, 64), (2, 96 * 96, 64), (1, 96 * 96, 256)])
def test_group_norm_plain_statistics_are_exact_at_dpt_widths(shape):
    """The fault item 3 showed: at the DPT-hybrid's widths the port's plain
    GroupNorm read 5.1e-5 (stem, [1, 36864, 64]) and 1.5e-5 off an fp64
    GroupNorm where the JAX package reads 2e-7; its statistics now sum in
    fp64 on the CPU."""
    rs = np.random.RandomState(0)
    b, t, c = shape
    x = (3 * np.maximum(rs.randn(b, t, c), 0) + 0.5).astype(np.float32)
    g = (1 + 0.1 * rs.randn(c)).astype(np.float32)
    beta = (0.05 * rs.randn(c)).astype(np.float32)
    xd = x.astype(np.float64).reshape(b, t, 32, c // 32)
    mean = xd.mean(axis=(1, 3), keepdims=True)
    var = ((xd - mean) ** 2).mean(axis=(1, 3), keepdims=True)
    exact = ((xd - mean) / np.sqrt(var + 1e-5)).reshape(b, t, c) * g + beta
    ours = tnorm.group_norm_plain(*map(torch.from_numpy, (x, g, beta)), 32, 1e-5).numpy()
    ref = np.asarray(jnorm.group_norm_act(jnp.asarray(x), jnp.asarray(g), jnp.asarray(beta),
                                          32, 1e-5))
    assert fw.rel_err(ours, exact) < 1e-6
    assert fw.rel_err(ours, ref) < 1e-6


def test_plain_attention_query_blocks_equal_the_dense_version(monkeypatch):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 300, 3, 8, generator=g) for _ in range(3))
    per_row = torch.randn(2, 3, 300, 300, generator=g)
    broadcast = torch.randn(1, 1, 1, 300, generator=g)
    dense = [tflash.flash_attention_plain(q, k, v, 0.3, b) for b in (None, per_row, broadcast)]
    monkeypatch.setattr(tflash, "PLAIN_MAX_LOGITS", 2 * 3 * 300 * 7)  # blocks of 7 queries
    blocked = [tflash.flash_attention_plain(q, k, v, 0.3, b) for b in (None, per_row, broadcast)]
    for a, b in zip(blocked, dense):
        assert torch.equal(a, b)


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def test_phase_20_fan_in_refill_is_seeded_and_scaled_by_fan_in():
    cs = _chip_smoke()
    cfg = UNetConfig(block_out_channels=(32, 64, 64, 64), attention_head_dim=2,
                     cross_attention_dim=64, norm_num_groups=8, motion_num_attention_heads=2)
    nets = [UNet3DConditionModel(cfg) for _ in range(3)]
    for net, seed in zip(nets, (7, 7, 8)):
        cs.fan_in_init_(net, torch.Generator().manual_seed(seed))
    a, b, c = (dict(n.named_parameters()) for n in nets)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    for name, p in a.items():
        if p.dim() > 1 and p.numel() >= 4096:
            fan_in = p[0].numel()
            assert abs(float(p.detach().std()) * fan_in ** 0.5 - 1) < 0.1, name
        elif p.dim() == 1 and p.numel() >= 256:
            p = p.detach()
            if name.endswith("weight"):
                assert abs(float(p.mean()) - 1) < 0.03 and abs(float(p.std()) - 0.1) < 0.03, name
            else:
                assert abs(float(p.std()) - 0.05) < 0.015, name


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))),
                         ids=os.path.basename)
def test_dump_config_round_trips_and_matches_jax(path, tmp_path):
    ours, ref = tconfig.load_config(path), jconfig.load_config(path)
    text = tconfig.dump_config(ours, str(tmp_path / "out.yaml"))
    assert text == jconfig.dump_config(ref)
    assert (tmp_path / "out.yaml").read_text() == text
    assert yaml.safe_load(text) == ours.to_dict()
    assert tconfig.load_config(str(tmp_path / "out.yaml")).to_dict() == ours.to_dict()
    assert tconfig.dump_config(ours.to_dict()) == text  # a plain dict too


def test_aot_probe_takes_spatial_qk_and_steps(tmp_path, capsys, monkeypatch):
    from live2diff_tpu_torch import wrapper as twrapper

    seen = {}
    real = twrapper.StreamV2VWrapper

    class Spy(real):
        def __init__(self, config, *a, **kw):
            seen.update(kw, t_index_list=config["t_index_list"])
            super().__init__(config, *a, **kw)

    monkeypatch.setattr(twrapper, "StreamV2VWrapper", Spy)
    assert aot_probe.main(["load", "--tiny", "--device", "cpu", "--spatial-qk", "int8",
                           "--steps", "30", "40", "--engine-dir", str(tmp_path)]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["phase"] == "load" and r["first_step_s"] > 0
    assert seen["flash_variant"] == "int8" and seen["t_index_list"] == [30, 40]
