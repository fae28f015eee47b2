"""The slice as a whole: the port's stream runtime against the JAX one.

The JAX ``StreamDiffusionDepth`` is built as tests/conftest.py's
``tiny_pipeline`` fixture builds it (tiny UNet, TAESD hidden 8, 64x64
frames, steps [30, 40], no depth model), the port's from the same weights.
Both run ``prepare`` on 8 warmup frames and then stream 20 frames: through
the window fill and past the point where the 16-slot window starts to
evict (frame 7 with sink 8). The port's noise is the JAX draws, read off
the JAX state's PRNG key before each frame.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    PROMPT_LEN, TINY_H, TINY_W, jax_taesd, jax_unet, port_taesd, port_unet, rel_err, to_np,
)
from live2diff_tpu.schedule import LCMSchedule as JaxLCMSchedule
from live2diff_tpu.stream.pipeline import StreamConfig as JaxStreamConfig
from live2diff_tpu.stream.pipeline import StreamDiffusionDepth as JaxStream
from live2diff_tpu_torch.schedule import LCMSchedule
from live2diff_tpu_torch.stream.pipeline import StreamConfig, StreamDiffusionDepth

WARM, N_FRAMES, SEED = 8, 20, 5
LH, LW = TINY_H // 8, TINY_W // 8
STEPS = 2

# fp32 cache: both sides run the same fp32 math in another order; 1e-3
# relative per frame leaves room for that rounding to grow through the
# recurrent stream (cache and latent buffers carry it from frame to frame).
FP32_TOL = 1e-3
# int8 cache: a K/V value that lands within fp32 rounding of a .5
# quantisation boundary can round to different int8 codes on the two
# sides: one LSB, scale/127 of that channel's range, in one cache element.
# That perturbs later frames by ~1% of a channel's range at worst; 2e-2
# holds it while still failing on any real error in the quantised path.
INT8_TOL = 2e-2


@pytest.fixture(scope="module")
def weights():
    unet, unet_params = jax_unet(seed=0)
    vae, vae_params = jax_taesd(seed=1)
    return unet, unet_params, vae, vae_params


def _frames():
    """A slowly varying stream: base image + drift + per-frame detail, [-1, 1]."""
    rs = np.random.RandomState(99)
    base = rs.rand(TINY_H, TINY_W, 3).astype(np.float32)
    out = []
    for i in range(WARM + N_FRAMES):
        drift = 0.1 * np.sin(0.3 * i + np.linspace(0, 3, TINY_H))[:, None, None]
        detail = 0.05 * rs.rand(TINY_H, TINY_W, 3).astype(np.float32)
        out.append((np.clip(base + drift + detail, 0, 1) * 2 - 1).astype(np.float32))
    return np.stack(out)


class _Replay:
    """The port's noise function: hands out queued JAX draws in order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, shape):
        arr = self.draws.pop(0)
        assert tuple(arr.shape) == tuple(shape), (arr.shape, shape)
        return torch.from_numpy(np.array(arr))


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _run_pair(weights, cache: str):
    unet, unet_params, vae, vae_params = weights
    jcache, tcache = {"fp32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}[cache]
    jsched = JaxLCMSchedule.create(50, t_index_list=[30, 40])
    jpipe = JaxStream(
        unet, unet_params, jsched,
        JaxStreamConfig(height=TINY_H, width=TINY_W, vae_scaling=1.0, cache_dtype=jcache),
        lambda p, x: vae.apply(p, x, method=vae.encode),
        lambda p, z: vae.apply(p, z, method=vae.decode),
        depth_fn=None, vae_params=vae_params,
    )
    tpipe = StreamDiffusionDepth(
        port_unet(unet_params), port_taesd(vae_params),
        LCMSchedule.create(50, t_index_list=[30, 40]),
        StreamConfig(height=TINY_H, width=TINY_W, vae_scaling=1.0, cache_dtype=tcache),
        device="cpu", dtype=torch.float32,
    )
    frames = _frames()
    prompt = np.random.RandomState(23).randn(1, PROMPT_LEN, 12).astype(np.float32)

    jstate, jwarm = jpipe.prepare(frames[:WARM], jnp.asarray(prompt), seed=SEED)
    # _warmup_denoise: one split for the encode noise, one per extra step
    rng, r_enc = jax.random.split(jax.random.PRNGKey(SEED))
    draws = [_normal(r_enc, (WARM, LH, LW, 4))]
    for _ in range(STEPS - 1):
        rng, r = jax.random.split(rng)
        draws.append(_normal(r, (WARM, LH, LW, 4)))
    tstate, twarm = tpipe.prepare(
        torch.from_numpy(frames[:WARM]), torch.from_numpy(prompt), noise=_Replay(draws)
    )
    pairs = [(to_np(twarm), np.asarray(jwarm))]
    for frame in frames[WARM:]:
        _, r_enc, r_buf = jax.random.split(jstate.rng, 3)
        replay = _Replay([_normal(r_enc, (1, LH, LW, 4)), _normal(r_buf, (STEPS - 1, LH, LW, 4))])
        jstate, jout = jpipe(jstate, frame)
        tstate, tout = tpipe(tstate, torch.from_numpy(frame), noise=replay)
        assert not replay.draws
        pairs.append((to_np(tout), np.asarray(jout)))
    return pairs


@pytest.mark.parametrize("cache,tol", [("fp32", FP32_TOL), ("int8", INT8_TOL)])
def test_stream_matches_jax_through_window_eviction(weights, cache, tol):
    pairs = _run_pair(weights, cache)
    assert len(pairs) == 1 + N_FRAMES
    for i, (ours, ref) in enumerate(pairs):
        assert ours.shape == ref.shape
        assert np.isfinite(ours).all()
        err = rel_err(ours, ref)
        assert err < tol, f"{'warmup' if i == 0 else f'frame {i - 1}'}: rel err {err:.2e}"
