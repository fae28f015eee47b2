"""The port at a non-square frame with odd latent dims, against the JAX package.

A 64x96 frame gives an 8x12 latent, which the UNet's stride-2 convs halve
with ceil to 4x6, 2x3 and 1x2 (tests/test_nonsquare.py:9): the KV-cache
shapes, the skip concatenations and the up path's output sizes all follow
the odd dims. The port's stream (tiny UNet, TAESD hidden 8, the weights of
tests/_torch_parity.py) runs ``prepare`` and a few frames beside the JAX
one, with the JAX noise draws replayed, as tests/test_torch_pipeline.py
does at 64x64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    PROMPT_LEN, TINY_UNET, jax_taesd, jax_unet, port_taesd, port_unet, rel_err, to_np,
)
from live2diff_tpu.models.unet import UNetConfig as JaxUNetConfig
from live2diff_tpu.schedule import LCMSchedule as JaxLCMSchedule
from live2diff_tpu.stream.pipeline import StreamConfig as JaxStreamConfig
from live2diff_tpu.stream.pipeline import StreamDiffusionDepth as JaxStream
from live2diff_tpu_torch.models.unet import UNetConfig
from live2diff_tpu_torch.ops.attention import dot_product_attention
from live2diff_tpu_torch.schedule import LCMSchedule
from live2diff_tpu_torch.stream.pipeline import StreamConfig, StreamDiffusionDepth

H, W = 64, 96
LH, LW = H // 8, W // 8
WARM, FRAMES, STEPS, SEED = 8, 4, 2, 7
# as tests/test_torch_pipeline.py: fp32 caches differ by summation order,
# grown through the recurrent stream (1e-3); an int8 code may round the
# other way at a .5 boundary on one side (2e-2)
TOLS = {"fp32": 1e-3, "int8": 2e-2}


@pytest.mark.parametrize("lh,lw", [(8, 12), (12, 8), (10, 10), (64, 96)])
def test_cache_shapes_match_jax_at_odd_dims(lh, lw):
    """Ceil-halving per level, as the JAX config computes it; (64, 96) is
    bench.py's 768x512 row, whose top level holds S = 6144 positions."""
    ours = UNetConfig(**TINY_UNET).cache_shapes(lh, lw, 2)
    ref = JaxUNetConfig(**TINY_UNET).cache_shapes(lh, lw, 2)
    assert [tuple(s) for s in ours] == [tuple(s) for s in ref]


def test_768x512_self_attentions_take_the_flash_variant(monkeypatch):
    """At 768x512 the full UNet's spatial self-attention runs at S = 6144
    (64x96) and 1536 (32x48): both pass the flash gate, and the int8 variant
    groups them as the JAX dispatch does (block_q 512; block_k min(S, 4096),
    shrunk to 3072 and 1536 by pick_block)."""
    from live2diff_tpu_torch.ops import attention as tattn

    seen = []
    monkeypatch.setattr(tattn, "flash_self_attention_int8",
                        lambda q, k, v, scale, block_q, block_k: seen.append(
                            (q.shape[2], block_q, block_k)) or q)
    for s in (64 * 96, 32 * 48, 16 * 24):
        x = torch.zeros(1, s, 1, 8)
        dot_product_attention(x, x, x, flash_variant="int8")
    assert seen == [(6144, 512, 4096), (1536, 512, 1536)]  # S = 384 keeps d-major


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


@pytest.mark.parametrize("cache", ["fp32", "int8"])
def test_stream_matches_jax_at_64x96(cache):
    unet, unet_params = jax_unet(seed=0)
    vae, vae_params = jax_taesd(seed=1)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}[cache]
    jpipe = JaxStream(
        unet, unet_params, JaxLCMSchedule.create(50, t_index_list=[30, 40]),
        JaxStreamConfig(height=H, width=W, vae_scaling=1.0, cache_dtype=jdt),
        lambda p, x: vae.apply(p, x, method=vae.encode),
        lambda p, z: vae.apply(p, z, method=vae.decode), vae_params=vae_params,
    )
    tpipe = StreamDiffusionDepth(
        port_unet(unet_params), port_taesd(vae_params),
        LCMSchedule.create(50, t_index_list=[30, 40]),
        StreamConfig(height=H, width=W, vae_scaling=1.0, cache_dtype=tdt),
        device="cpu", dtype=torch.float32,
    )
    rs = np.random.RandomState(31)
    frames = rs.uniform(-1, 1, (WARM + FRAMES, H, W, 3)).astype(np.float32)
    prompt = rs.randn(1, PROMPT_LEN, 12).astype(np.float32)

    jstate, jwarm = jpipe.prepare(frames[:WARM], jnp.asarray(prompt), seed=SEED)
    rng, r_enc = jax.random.split(jax.random.PRNGKey(SEED))
    draws = [_normal(r_enc, (WARM, LH, LW, 4))]
    for _ in range(STEPS - 1):
        rng, r = jax.random.split(rng)
        draws.append(_normal(r, (WARM, LH, LW, 4)))
    tstate, twarm = tpipe.prepare(torch.from_numpy(frames[:WARM]), torch.from_numpy(prompt),
                                  noise=_Replay(draws))
    pairs = [(to_np(twarm), np.asarray(jwarm))]
    for frame in frames[WARM:]:
        _, r_enc, r_buf = jax.random.split(jstate.rng, 3)
        replay = _Replay([_normal(r_enc, (1, LH, LW, 4)),
                          _normal(r_buf, (STEPS - 1, LH, LW, 4))])
        jstate, jout = jpipe(jstate, frame)
        tstate, tout = tpipe(tstate, torch.from_numpy(frame), noise=replay)
        assert not replay.draws
        pairs.append((to_np(tout), np.asarray(jout)))
    first = tstate.kv_caches[0]
    assert (first[0] if isinstance(first, tuple) else first).shape[-1] == LH * LW
    for i, (ours, ref) in enumerate(pairs):
        assert ours.shape == ref.shape == ((WARM, H, W, 3) if i == 0 else (H, W, 3))
        assert np.isfinite(ours).all()
        err = rel_err(ours, ref)
        assert err < TOLS[cache], f"{'warmup' if i == 0 else f'frame {i - 1}'}: {err:.2e}"
