"""The port's model modules against the JAX package's, on the same weights.

Weights are drawn over the flax modules' ``eval_shape`` and carried across
with ``params_from_jax`` (``strict=True``: every port parameter has a JAX
counterpart). Everything runs in fp32 on the CPU; the two frameworks then
differ only in summation order, so outputs agree to 1e-5 relative (5e-5
through the whole UNet, whose ~100 layers compound it). With an int8 cache a
code may flip by one where fp32 rounding lands on a .5 boundary (1/127 of
that channel's range), and the flip reaches every later layer's K/V: int8
caches are compared dequantised, and int8 outputs and caches are held to
2e-2 relative, a few quantisation steps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    PROMPT_LEN, TINY_UNET, caches_to_np, jax_taesd, jax_unet, port_taesd, port_unet,
    random_params_like, rel_err,
)
from live2diff_tpu.models import attention as jatt
from live2diff_tpu.models import layers as jl
from live2diff_tpu.models import motion as jmo
from live2diff_tpu.models import resnet as jres
from live2diff_tpu.models.unet import UNetConfig as JaxUNetConfig
from live2diff_tpu.stream.state_machine import (
    init_window_state, mask_to_bias, update_window_state,
)
from live2diff_tpu_torch.convert.from_jax import params_from_jax
from live2diff_tpu_torch.models import attention as tatt
from live2diff_tpu_torch.models import layers as tl
from live2diff_tpu_torch.models import motion as tmo
from live2diff_tpu_torch.models import resnet as tres
from live2diff_tpu_torch.models.unet import UNetConfig
from live2diff_tpu_torch.stream import state_machine as tsm

T = torch.from_numpy
TOL = 1e-5
UNET_TOL = 5e-5
INT8_TOL = 2e-2


def _pair(jmod, tmod, *jargs, seed=0, **jkw):
    """Init ``jmod`` over its eval_shape with numpy weights, load them into
    ``tmod``; returns (jax params, torch module)."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jargs, **jkw))
    params = random_params_like(shapes, seed)
    tmod.load_state_dict(params_from_jax(params), strict=True)
    return params, tmod.eval()


def _check(jmod, tmod, *args, tol=TOL):
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    params, tmod = _pair(jmod, tmod, *jargs)
    ref = jmod.apply(params, *jargs)
    with torch.no_grad():
        out = tmod(*[T(a) if isinstance(a, np.ndarray) else a for a in args])
    assert tuple(out.shape) == tuple(ref.shape)
    assert rel_err(out.numpy(), ref) < tol


def test_timestep_embedding_and_pe_table_match_jax():
    t = np.array([0, 261, 999], np.int32)
    ref = jl.timestep_embedding(jnp.asarray(t), 8)
    assert rel_err(tl.timestep_embedding(T(t), 8).numpy(), ref) < TOL
    pe = tl.sinusoidal_table(24, 16, torch.device("cpu"), torch.float32)
    assert rel_err(pe.numpy(), jl.sinusoidal_table(24, 16)) < TOL


def test_layers_match_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 16).astype(np.float32)
    _check(jl.TimestepEmbedding(32), tl.TimestepEmbedding(16, 32), x)
    _check(jl.GEGLUFeedForward(dim=16), tl.GEGLUFeedForward(16), x)
    _check(jl.FusedLayerNorm(epsilon=1e-5), tl.FusedLayerNorm(16, 1e-5), x)
    x4 = (rs.randn(2, 4, 4, 16) + 3.0).astype(np.float32)  # |mean| >> std
    _check(jl.FusedGroupNorm(num_groups=4, epsilon=1e-6, act="silu"),
           tl.FusedGroupNorm(4, 16, 1e-6, act="silu"), x4)


def test_resnet_blocks_match_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 1, 6, 6, 8).astype(np.float32)
    temb = rs.randn(2, 32).astype(np.float32)
    _check(jres.ResnetBlock3D(out_channels=16, groups=4, eps=1e-5),
           tres.ResnetBlock3D(8, 16, 32, 4, 1e-5), x, temb)
    _check(jres.Downsample3D(8), tres.Downsample3D(8), rs.randn(1, 2, 5, 7, 8).astype(np.float32))
    _check(jres.MappingNetwork(embedding_channels=8), tres.MappingNetwork(8),
           rs.randn(2, 1, 4, 4, 4).astype(np.float32))
    # nearest upsample to an explicit odd output size, then conv
    xu = rs.randn(1, 2, 3, 4, 8).astype(np.float32)
    params, tmod = _pair(jres.Upsample3D(8), tres.Upsample3D(8), jnp.asarray(xu), output_size=(5, 8))
    ref = jres.Upsample3D(8).apply(params, jnp.asarray(xu), output_size=(5, 8))
    with torch.no_grad():
        out = tmod(T(xu), output_size=(5, 8))
    assert rel_err(out.numpy(), ref) < TOL


def test_spatial_transformer_matches_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 1, 4, 4, 16).astype(np.float32)
    ctx = rs.randn(2, PROMPT_LEN, 12).astype(np.float32)
    _check(
        jatt.Transformer3DModel(heads=2, dim_head=8, cross_attention_dim=12, norm_num_groups=4),
        tatt.Transformer3DModel(16, 2, 8, cross_attention_dim=12, norm_num_groups=4),
        x, ctx,
    )


def _dequant(arrays, int8: bool):
    """Numpy cache arrays -> float caches (data * scales for int8 pairs)."""
    if not int8:
        return arrays
    return [d.astype(np.float64) * s[..., None] for d, s in zip(arrays[0::2], arrays[1::2])]


def _assert_caches_match(tcaches, jcaches, int8: bool, tol: float = TOL):
    t, j = _dequant(caches_to_np(tcaches), int8), _dequant(caches_to_np(jcaches), int8)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert rel_err(a, b) < (INT8_TOL if int8 else tol)


@pytest.mark.parametrize("cache", ["fp32", "int8"])
def test_motion_module_warmup_and_stream_match_jax(cache):
    """TemporalAttention through its transformer: warmup fills slots 0..7,
    then a stream call writes its slot and attends over the window."""
    int8 = cache == "int8"
    rs = np.random.RandomState(3)
    c, heads, hw = 16, 2, 6
    shape = (2, 2, 16, c, hw)
    jmk = lambda: ((jnp.zeros(shape, jnp.int8), jnp.ones(shape[:4])) if int8  # noqa: E731
                   else jnp.zeros(shape))
    tmk = lambda: ((torch.zeros(shape, dtype=torch.int8), torch.ones(shape[:4])) if int8  # noqa: E731
                   else torch.zeros(shape))
    jmod = jmo.TemporalTransformer3DModel(heads=heads, norm_num_groups=4)
    tmod = tmo.TemporalTransformer3DModel(c, heads, norm_num_groups=4)
    xw = rs.randn(1, 8, 2, 3, c).astype(np.float32)
    params, tmod = _pair(jmod, tmod, jnp.asarray(xw), [jmk(), jmk()], "warmup", None, None,
                         None, 0)
    jc, tc = [jmk(), jmk()], [tmk(), tmk()]
    with torch.no_grad():
        for step in range(2):  # warmup fills both step rows
            ref, jc = jmod.apply(params, jnp.asarray(xw), jc, "warmup", None, None, None, step)
            out, tc = tmod(T(xw), tc, "warmup", None, None, None, step)
            assert rel_err(out.numpy(), ref) < TOL
        _assert_caches_match(tc, jc, int8)
        jstate = init_window_state(2)
        tstate = tsm.init_window_state(2)
        for frame in range(3):
            xs = rs.randn(2, 1, 2, 3, c).astype(np.float32)
            ref, jc = jmod.apply(params, jnp.asarray(xs), jc, "stream",
                                 mask_to_bias(jstate[0]), jstate[1], jstate[2])
            out, tc = tmod(T(xs), tc, "stream", tsm.mask_to_bias(tstate[0]), tstate[1], tstate[2])
            assert rel_err(out.numpy(), ref) < (INT8_TOL if int8 else TOL), f"frame {frame}"
            _assert_caches_match(tc, jc, int8)
            jstate = update_window_state(*jstate)
            tstate = tsm.update_window_state(*tstate)


@pytest.mark.parametrize("cache", ["fp32", "int8"])
def test_unet_warmup_and_stream_match_jax(cache):
    """Warmup forward (row 0 of every cache), then a stream forward over the
    2-step batch: outputs and all 40 caches."""
    int8 = cache == "int8"
    unet, params = jax_unet(seed=4)
    tunet = port_unet(params)
    cfg = JaxUNetConfig(**TINY_UNET)
    jc = cfg.init_caches(8, 8, 2, dtype=jnp.int8 if int8 else jnp.float32)
    tc = UNetConfig(**TINY_UNET).init_caches(8, 8, 2, dtype=torch.int8 if int8 else torch.float32)
    rs = np.random.RandomState(5)
    ctx = rs.randn(2, PROMPT_LEN, 12).astype(np.float32)
    xw, dw = (rs.randn(1, 8, 8, 8, 4).astype(np.float32) for _ in range(2))
    apply = jax.jit(unet.apply, static_argnums=(6, 10))
    with torch.no_grad():
        ref, jc = apply(params, jnp.asarray(xw), jnp.array([261]), jnp.asarray(ctx[:1]),
                        jnp.asarray(dw), jc, "warmup", None, None, None, 0)
        out, tc = tunet(T(xw), torch.tensor([261]), T(ctx[:1]), T(dw), tc, "warmup",
                        None, None, None, 0)
        assert rel_err(out.numpy(), ref) < UNET_TOL
        _assert_caches_match(tc, jc, int8, UNET_TOL)

        xs, ds = (rs.randn(2, 1, 8, 8, 4).astype(np.float32) for _ in range(2))
        mask, pe_idx, update_idx = init_window_state(2)
        tmask, tpe, tupd = tsm.init_window_state(2)
        ref, jc = apply(params, jnp.asarray(xs), jnp.array([261, 61]), jnp.asarray(ctx),
                        jnp.asarray(ds), jc, "stream", mask_to_bias(mask), pe_idx, update_idx)
        out, tc = tunet(T(xs), torch.tensor([261, 61]), T(ctx), T(ds), tc, "stream",
                        tsm.mask_to_bias(tmask), tpe, tupd)
        assert rel_err(out.numpy(), ref) < (INT8_TOL if int8 else UNET_TOL)
        _assert_caches_match(tc, jc, int8, UNET_TOL)


def test_taesd_encode_decode_match_jax():
    vae, params = jax_taesd(seed=6)
    tvae = port_taesd(params)
    rs = np.random.RandomState(7)
    x = rs.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    z = rs.randn(1, 8, 8, 4).astype(np.float32) * 2.0
    with torch.no_grad():
        enc = tvae.encode(T(x))
        dec = tvae.decode(T(z))
    ref_enc = vae.apply(params, jnp.asarray(x), method=vae.encode)
    ref_dec = vae.apply(params, jnp.asarray(z), method=vae.decode)
    assert enc.shape == (2, 8, 8, 4) and dec.shape == (1, 64, 64, 3)
    assert rel_err(enc.numpy(), ref_enc) < TOL
    assert rel_err(dec.numpy(), ref_dec) < TOL
