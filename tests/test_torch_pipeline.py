"""The slice as a whole: the port's stream runtime against the JAX one.

The JAX ``StreamDiffusionDepth`` is built as tests/conftest.py's
``tiny_pipeline`` fixture builds it (tiny UNet, TAESD hidden 8, 64x64
frames, steps [30, 40], no depth model), the port's from the same weights.
Both run ``prepare`` on 8 warmup frames and then stream 20 frames: through
the window fill and past the point where the 16-slot window starts to
evict (frame 7 with sink 8). The port's noise is the JAX draws, read off
the JAX state's PRNG key before each frame.

With depth, both streams also get the narrow 384x384 DPT (the same weights)
and run ``prepare`` plus 10 frames: each frame goes through the DPT, the
batch min-max normalisation and one encode of frame and depth image. The
JAX noise draws do not change with depth. Without added noise
(``do_add_noise=False``) the step draws only the encode noise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    NARROW_DPT, PROMPT_LEN, TINY_H, TINY_W, jax_dpt, jax_taesd, jax_unet, port_dpt, port_taesd,
    port_unet, rel_err, to_np,
)
from live2diff_tpu.schedule import LCMSchedule as JaxLCMSchedule
from live2diff_tpu.stream.pipeline import StreamConfig as JaxStreamConfig
from live2diff_tpu.stream.pipeline import StreamDiffusionDepth as JaxStream
from live2diff_tpu_torch.schedule import LCMSchedule
from live2diff_tpu_torch.stream.pipeline import StreamConfig, StreamDiffusionDepth

WARM, N_FRAMES, DEPTH_FRAMES, SEED = 8, 20, 10, 5
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


@pytest.fixture(scope="module")
def depth():
    """(flax DPT, its params, the port's DPT on the same weights)."""
    dpt, params = jax_dpt(NARROW_DPT)
    return dpt, params, port_dpt(params, NARROW_DPT)


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


def _pipes(weights, cache: str, depth=None, do_add_noise: bool = True):
    """The JAX stream and the port's, on the same weights."""
    unet, unet_params, vae, vae_params = weights
    jcache, tcache = {"fp32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}[cache]
    dpt, dpt_params, tdpt = depth or (None, None, None)
    jsched = JaxLCMSchedule.create(50, t_index_list=[30, 40])
    jpipe = JaxStream(
        unet, unet_params, jsched,
        JaxStreamConfig(height=TINY_H, width=TINY_W, vae_scaling=1.0, cache_dtype=jcache,
                        do_add_noise=do_add_noise),
        lambda p, x: vae.apply(p, x, method=vae.encode),
        lambda p, z: vae.apply(p, z, method=vae.decode),
        depth_fn=None if dpt is None else dpt.apply, vae_params=vae_params,
        depth_params=dpt_params,
    )
    tpipe = StreamDiffusionDepth(
        port_unet(unet_params), port_taesd(vae_params),
        LCMSchedule.create(50, t_index_list=[30, 40]),
        StreamConfig(height=TINY_H, width=TINY_W, vae_scaling=1.0, cache_dtype=tcache,
                     do_add_noise=do_add_noise),
        device="cpu", dtype=torch.float32, depth_model=tdpt,
    )
    return jpipe, tpipe


def _run_pair(weights, cache: str, depth=None, do_add_noise: bool = True,
              n_frames: int = N_FRAMES):
    """prepare + ``n_frames`` streamed frames on both sides: a list of
    (port output, JAX output) pairs, warmup first."""
    jpipe, tpipe = _pipes(weights, cache, depth, do_add_noise)
    frames = _frames()[:WARM + n_frames]
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
        draws = [_normal(r_enc, (1, LH, LW, 4))]
        if do_add_noise:
            draws.append(_normal(r_buf, (STEPS - 1, LH, LW, 4)))
        replay = _Replay(draws)
        jstate, jout = jpipe(jstate, frame)
        tstate, tout = tpipe(tstate, torch.from_numpy(frame), noise=replay)
        assert not replay.draws
        pairs.append((to_np(tout), np.asarray(jout)))
    return pairs


def _assert_pairs(pairs, n_frames, tol):
    assert len(pairs) == 1 + n_frames
    for i, (ours, ref) in enumerate(pairs):
        assert ours.shape == ref.shape
        assert np.isfinite(ours).all()
        err = rel_err(ours, ref)
        assert err < tol, f"{'warmup' if i == 0 else f'frame {i - 1}'}: rel err {err:.2e}"


@pytest.mark.parametrize("cache,tol", [("fp32", FP32_TOL), ("int8", INT8_TOL)])
def test_stream_matches_jax_through_window_eviction(weights, cache, tol):
    _assert_pairs(_run_pair(weights, cache), N_FRAMES, tol)


@pytest.mark.parametrize("cache,tol", [("fp32", FP32_TOL), ("int8", INT8_TOL)])
def test_stream_with_depth_matches_jax(weights, depth, cache, tol):
    _assert_pairs(_run_pair(weights, cache, depth=depth, n_frames=DEPTH_FRAMES),
                  DEPTH_FRAMES, tol)


def test_depth_image_matches_jax_and_is_not_flat(weights, depth):
    """The normalised depth image of the 8 warmup frames: the JAX one, and
    spread across pixels (a flat map would make the depth branch a no-op)."""
    jpipe, tpipe = _pipes(weights, "fp32", depth=depth)
    frames = _frames()[:WARM]
    ref = np.asarray(jax.jit(jpipe._depth_image)(jpipe.params, jnp.asarray(frames)))
    with torch.no_grad():
        ours = tpipe._depth_image(torch.from_numpy(frames)).numpy()
    assert ours.shape == (WARM, TINY_H, TINY_W, 3)
    assert ours.min() >= -1.0 and ours.max() <= 1.0
    assert ours.std() > 0.1, ours.std()
    assert rel_err(ours, ref) < FP32_TOL


def test_stream_without_added_noise_matches_jax(weights):
    _assert_pairs(_run_pair(weights, "fp32", do_add_noise=False, n_frames=DEPTH_FRAMES),
                  DEPTH_FRAMES, FP32_TOL)
