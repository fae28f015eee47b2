"""``parallel/infer.py`` and ``train_step_dryrun`` on the CPU: the caches per
rank, and two gloo ranks against one process.

One spawn of two ranks (``tests/_torch_infer_ranks.py``) runs, on the mesh
(dp, tp) = (1, 2) and on (2, 1):

* ``stream_step_tp_dryrun`` and ``train_step_dryrun``: the same output mean
  and loss as one process, within 1e-5 and 1e-6 (the row-parallel sums add
  in another order);
* ``tp_stream_check`` on the dryruns' tiny UNet (warmup, then 4 frames):
  with an fp32 cache every frame within 1e-5 relative RMS of the unsharded
  step and each rank's caches within 1e-5 of the unsharded caches'
  channel slab; with an int8 cache within 2e-2 (a K/V value within rounding
  of a .5 boundary may take the next code, tests/test_torch_models.py's
  bound), codes off by at most one, in under 1 % of them; at least 60 % of
  the parameter bytes on tp;
* ``multi_session_run`` with 4 sessions over dp = 2 against one
  ``MultiStream`` of 4: each session's outputs and noised latents within
  1e-4 (the batched products at another batch size round differently,
  tests/test_torch_multi.py's fp32 bound); ``multi_session_dp_dryrun``'s
  mean the one-process run's rows' mean.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_infer_ranks import SESSIONS
from _torch_parity import rel_err
from _torch_ranks import spawn
from live2diff_tpu_torch.models.unet import UNetConfig
from live2diff_tpu_torch.parallel import infer
from live2diff_tpu_torch.parallel.mesh import Mesh
from live2diff_tpu_torch.parallel.train import train_step_dryrun

TOL, LOSS_TOL, INT8_TOL, SESSION_TOL = 1e-5, 1e-6, 2e-2, 1e-4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("infer")
    spawn("_torch_infer_ranks", 2, str(out))
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_cache_shapes_hold_each_ranks_channels(tp):
    full = UNetConfig().cache_shapes(64, 64, 2)
    ours = UNetConfig().cache_shapes(64, 64, 2, tp=tp)
    assert len(ours) == len(full) == 40
    assert all(o[:3] + o[4:] == f[:3] + f[4:] and o[3] * tp == f[3] for o, f in zip(ours, full))
    # 2 motion heads do not split over 4 ranks: those caches stay whole
    tiny = UNetConfig(**infer.DRYRUN_UNET)
    assert tiny.cache_shapes(8, 8, 2, tp=4) == tiny.cache_shapes(8, 8, 2)
    caches = tiny.init_caches(8, 8, 2, torch.int8, tp=2)
    assert caches[0][0].shape[3] == 8 and caches[0][1].shape == caches[0][0].shape[:4]


def test_cache_sharding_takes_contiguous_channel_slabs():
    config = UNetConfig(**infer.DRYRUN_UNET)
    g = torch.Generator().manual_seed(0)
    shape = config.cache_shapes(8, 8, 2)[0]  # [2, 2, 16, 16, 64]
    data = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    scales = torch.rand(shape[:4], generator=g)
    flt = torch.randn(shape, generator=g)
    for rank in range(2):
        (d, s), f = infer.cache_sharding(Mesh(1, 2, rank), ((data, scales), flt), config)
        for ours, full in ((d, data), (s, scales), (f, flt)):
            assert ours.is_contiguous() and ours.shape[3] == 8
            assert torch.equal(ours, full[:, :, :, 8 * rank:8 * (rank + 1)])
    whole = infer.cache_sharding(Mesh(1, 4, 3), (flt,), config)[0]
    assert torch.equal(whole, flt)


def test_dryruns_match_one_process(ranks):
    mean = infer.stream_step_tp_dryrun(Mesh(), device="cpu")
    loss = train_step_dryrun(Mesh(), device="cpu")
    for res in ranks:
        assert abs(res["stream_dryrun"] - mean) <= TOL * abs(mean)
        for layout in ("train_tp", "train_dp"):
            assert abs(res[layout] - loss) <= LOSS_TOL * abs(loss), layout


@pytest.mark.parametrize("cache", ["fp32", "int8"])
def test_tp2_stream_check(ranks, cache):
    for res in ranks:
        r = res[f"check_{cache}"]
        assert len(r["rel_rms"]) == 4 and r["param_bytes_on_tp"] >= 0.60
        if cache == "fp32":
            assert max(r["rel_rms"]) <= TOL and r["caches"]["max_rel_err"] <= TOL, r
        else:
            c = r["caches"]
            assert max(r["rel_rms"]) <= INT8_TOL, r
            assert c["max_code_diff"] <= 1 and c["codes_differ_share"] < 0.01, c
            assert c["scales_max_rel_err"] <= INT8_TOL, c


def test_dp2_sessions_match_one_multistream(ranks):
    one = infer.multi_session_run(Mesh(), SESSIONS, device="cpu")
    per = SESSIONS // 2
    for r, res in enumerate(ranks):
        mine = slice(r * per, (r + 1) * per)
        got = res["sessions"]
        assert got["outputs"].shape == (2, per, 64, 64, 3)
        for key in ("outputs", "x_t_buffer"):
            ref = one[key][:, mine] if key == "outputs" else one[key][mine]
            assert rel_err(got[key], ref) < SESSION_TOL, (r, key)
        two = infer.multi_session_run(Mesh(), 2, rounds=1, device="cpu")["outputs"]
        assert np.isclose(res["sessions_dryrun"],
                          two[:, r:r + 1].astype(np.float64).mean(), rtol=1e-4)
