"""The port's attention and window-state figures (utils/attn_vis.py)
against ``live2diff_tpu/utils/attn_vis.py``.

Both packages lay a cache out as ``[steps, 2, window, C, HW]``, an int8 one
as ``(data, scales [steps, 2, window, C])`` (``live2diff_tpu/models/
unet.py:126-127``, ``live2diff_tpu_torch/stream/state.py``).

* A float cache: ``cache_slot_energy`` equals JAX's within 1e-6.
* An int8 cache: the port dequantises first, so it equals JAX's function on
  the dequantised cache; JAX's own function takes the RMS of the raw int8
  codes and drops the scales (``live2diff_tpu/utils/attn_vis.py:82``), and
  differs. The test states that difference.
* The three figures render to files.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from live2diff_tpu.utils import attn_vis as jax_vis
from live2diff_tpu_torch.stream.state_machine import init_window_state, update_window_state
from live2diff_tpu_torch.utils import attn_vis

STEPS, WINDOW, SINK = 2, 16, 8
# (C, HW) of three motion modules' caches
SHAPES = ((8, 64), (16, 16), (16, 4))


def _float_caches(rng):
    caches = []
    for c, hw in SHAPES:
        x = rng.randn(STEPS, 2, WINDOW, c, hw).astype(np.float32)
        # slots of very different energies, as sinks and rolling slots have
        x *= rng.uniform(0.01, 3.0, (STEPS, 2, WINDOW, 1, 1)).astype(np.float32)
        caches.append(x)
    return caches


def _quantise(x):
    """Per-(slot, channel) absmax int8, the caches' layout."""
    scales = np.abs(x).max(axis=-1) / 127.0
    data = np.round(x / np.maximum(scales, 1e-12)[..., None]).astype(np.int8)
    return data, scales.astype(np.float32)


def test_cache_slot_energy_matches_jax_on_a_float_cache():
    caches = _float_caches(np.random.RandomState(0))
    ours = attn_vis.cache_slot_energy(
        types.SimpleNamespace(kv_caches=tuple(torch.from_numpy(c) for c in caches)))
    ref = jax_vis.cache_slot_energy(types.SimpleNamespace(kv_caches=tuple(caches)))
    assert ours.shape == (len(SHAPES), STEPS, WINDOW)
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


def test_cache_slot_energy_dequantises_an_int8_cache():
    quantised = [_quantise(c) for c in _float_caches(np.random.RandomState(1))]
    ours = attn_vis.cache_slot_energy(types.SimpleNamespace(kv_caches=tuple(
        (torch.from_numpy(d), torch.from_numpy(s)) for d, s in quantised)))
    dequantised = tuple(d.astype(np.float32) * s[..., None] for d, s in quantised)
    np.testing.assert_allclose(
        ours, jax_vis.cache_slot_energy(types.SimpleNamespace(kv_caches=dequantised)),
        rtol=1e-6, atol=1e-6)
    # the JAX function on the int8 cache itself: the codes' RMS, every slot
    # near the same value whatever K held
    raw = jax_vis.cache_slot_energy(
        types.SimpleNamespace(kv_caches=tuple((d, s) for d, s in quantised)))
    assert np.abs(raw - ours).max() > 10.0
    assert raw.std() / raw.mean() < 0.25 < ours.std() / ours.mean()


def test_figures_render(tmp_path):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    mask, pe_idx, update_idx = init_window_state(STEPS, WINDOW, SINK, device="cpu")
    for _ in range(3):
        update_window_state(mask, pe_idx, update_idx, SINK, out=(mask, pe_idx, update_idx))
    caches = tuple(torch.from_numpy(c) for c in _float_caches(np.random.RandomState(2)))
    state = types.SimpleNamespace(attn_mask=mask, pe_idx=pe_idx, update_idx=update_idx,
                                  kv_caches=caches)
    paths = [tmp_path / n for n in ("attn.png", "window.png", "energy.png")]
    probs = torch.softmax(torch.randn(6, 6), -1)
    attn_vis.visualize_attn_map(probs, str(paths[0]))
    attn_vis.window_state_figure(state, str(paths[1]))
    attn_vis.cache_energy_figure(state, str(paths[2]))
    for p in paths:
        assert p.stat().st_size > 1000 and p.read_bytes()[:4] == b"\x89PNG"
    fig = attn_vis.cache_energy_figure(state)
    assert len(fig.axes) == 2 * STEPS  # a panel and a colorbar a step
