"""Cross-frame attention (``unet_use_cross_frame_attention``, the original's
SparseCausalAttention) in the port against the JAX package.

Over a clip of F > 1 frames (the warmup) each frame's spatial
self-attention takes the keys of frame 0 and its own values; over one frame
(stream mode) it is ordinary self-attention. Held against JAX on the same
weights at module level and through the tiny UNet (warmup, then 4 stream
frames over a fp32 cache), at tests/test_torch_models.py's tolerances, and
shown to differ from plain self-attention in warmup only.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import PROMPT_LEN, TINY_UNET, random_params_like, rel_err
from live2diff_tpu.models import attention as jatt
from live2diff_tpu.models.unet import UNet3DConditionModel as JaxUNet
from live2diff_tpu.models.unet import UNetConfig as JaxUNetConfig
from live2diff_tpu.stream.state_machine import init_window_state, mask_to_bias, update_window_state
from live2diff_tpu_torch.convert.from_jax import params_from_jax
from live2diff_tpu_torch.models import attention as tatt
from live2diff_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from live2diff_tpu_torch.stream import state_machine as tsm
from test_torch_models import UNET_TOL, _assert_caches_match

T = torch.from_numpy
TOL = 1e-5  # one attention in fp32: summation order only
CROSS = dict(TINY_UNET, unet_use_cross_frame_attention=True)


def _attention_pair(video_length: int, seed: int = 0):
    rs = np.random.RandomState(seed)
    x = rs.randn(2 * video_length, 6, 16).astype(np.float32)  # [B*F, S, C]
    jmod = jatt.CrossAttention(query_dim=16, heads=2, dim_head=8, cross_frame=True)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                              video_length=video_length))
    params = random_params_like(shapes, seed)
    tmod = tatt.CrossAttention(16, 2, 8, cross_frame=True)
    tmod.load_state_dict(params_from_jax(params), strict=True)
    return x, jmod, params, tmod.eval()


@pytest.mark.parametrize("video_length", [1, 4])
def test_cross_frame_attention_matches_jax(video_length):
    x, jmod, params, tmod = _attention_pair(video_length)
    ref = jmod.apply(params, jnp.asarray(x), video_length=video_length)
    with torch.no_grad():
        out = tmod(T(x), video_length=video_length)
    assert rel_err(out.numpy(), ref) < TOL


def test_cross_frame_keys_are_frame_zeros():
    """Frame 0 of each clip sees what plain self-attention gives it; the
    other frames do not, and equal an attention whose keys are frame 0's."""
    f = 4
    x, _, _, tmod = _attention_pair(f, seed=1)
    plain = tatt.CrossAttention(16, 2, 8)
    plain.load_state_dict(tmod.state_dict())
    with torch.no_grad():
        cross = tmod(T(x), video_length=f).reshape(2, f, 6, 16)
        self_ = plain.eval()(T(x)).reshape(2, f, 6, 16)
        assert torch.allclose(cross[:, 0], self_[:, 0], atol=1e-6)
        assert (cross[:, 1:] - self_[:, 1:]).abs().amax() > 1e-2
        # by hand: q and v per frame, k of frame 0
        q, k, v = (m(T(x)).reshape(2, f, 6, 2, 8) for m in (tmod.to_q, tmod.to_k, tmod.to_v))
        k = k[:, :1].expand_as(k)
        att = torch.softmax(torch.einsum("bfqhd,bfkhd->bfhqk", q, k) * 8 ** -0.5, dim=-1)
        ref = tmod.to_out[0](torch.einsum("bfhqk,bfkhd->bfqhd", att, v).reshape(2, f, 6, 16))
        assert torch.allclose(cross, ref, atol=1e-5)
    with pytest.raises(ValueError, match="video_length"):
        tmod(T(x))


@pytest.fixture(scope="module")
def unets():
    """The tiny UNet with cross-frame attention, JAX and port, one set of
    weights; and the port's UNet without it on the same weights."""
    cfg = JaxUNetConfig(**CROSS)
    unet = JaxUNet(config=cfg, dtype=jnp.float32)
    caches = cfg.init_caches(8, 8, 2, dtype=jnp.float32)
    mask, pe_idx, update_idx = init_window_state(2)
    z = jnp.zeros((2, 1, 8, 8, 4))
    shapes = jax.eval_shape(lambda: unet.init(
        jax.random.PRNGKey(0), z, jnp.zeros((2,), jnp.int32), jnp.zeros((2, PROMPT_LEN, 12)),
        z, caches, "stream", mask_to_bias(mask), pe_idx, update_idx))
    params = random_params_like(shapes, 6)
    sd = params_from_jax(params)
    tunet = UNet3DConditionModel(UNetConfig(**CROSS))
    tunet.load_state_dict(sd, strict=True)
    plain = UNet3DConditionModel(UNetConfig(**TINY_UNET))
    plain.load_state_dict(sd, strict=True)
    return unet, params, tunet.eval(), plain.eval()


def _inputs(seed=5):
    rs = np.random.RandomState(seed)
    ctx = rs.randn(2, PROMPT_LEN, 12).astype(np.float32)
    xw, dw = (rs.randn(1, 8, 8, 8, 4).astype(np.float32) for _ in range(2))
    streams = [tuple(rs.randn(2, 1, 8, 8, 4).astype(np.float32) for _ in range(2))
               for _ in range(4)]
    return ctx, xw, dw, streams


def test_unet_cross_frame_warmup_and_stream_match_jax(unets):
    """Warmup (both step rows of every cache), then 4 stream frames over
    the window: outputs and all 40 caches, fp32."""
    unet, params, tunet, _ = unets
    ctx, xw, dw, streams = _inputs()
    jc = JaxUNetConfig(**CROSS).init_caches(8, 8, 2, dtype=jnp.float32)
    tc = UNetConfig(**CROSS).init_caches(8, 8, 2, dtype=torch.float32)
    apply = jax.jit(unet.apply, static_argnums=(6, 10))
    with torch.no_grad():
        for step, t in enumerate((261, 61)):
            ref, jc = apply(params, jnp.asarray(xw), jnp.array([t]), jnp.asarray(ctx[:1]),
                            jnp.asarray(dw), jc, "warmup", None, None, None, step)
            out, tc = tunet(T(xw), torch.tensor([t]), T(ctx[:1]), T(dw), tc, "warmup",
                            None, None, None, step)
            assert rel_err(out.numpy(), ref) < UNET_TOL, f"warmup step {step}"
        _assert_caches_match(tc, jc, False, UNET_TOL)
        jwin, twin = init_window_state(2), tsm.init_window_state(2)
        for i, (xs, ds) in enumerate(streams):
            ref, jc = apply(params, jnp.asarray(xs), jnp.array([261, 61]), jnp.asarray(ctx),
                            jnp.asarray(ds), jc, "stream", mask_to_bias(jwin[0]), jwin[1],
                            jwin[2])
            out, tc = tunet(T(xs), torch.tensor([261, 61]), T(ctx), T(ds), tc, "stream",
                            tsm.mask_to_bias(twin[0]), twin[1], twin[2])
            assert rel_err(out.numpy(), ref) < UNET_TOL, f"stream frame {i}"
            _assert_caches_match(tc, jc, False, UNET_TOL)
            jwin, twin = update_window_state(*jwin), tsm.update_window_state(*twin)


def test_cross_frame_changes_the_warmup_only(unets):
    """The same weights with and without cross-frame attention: the warmup
    forward differs, a stream forward (one frame a clip) is the same."""
    _, _, tunet, plain = unets
    ctx, xw, dw, streams = _inputs(seed=7)
    cfg = UNetConfig(**TINY_UNET)
    with torch.no_grad():
        a, _ = tunet(T(xw), torch.tensor([261]), T(ctx[:1]), T(dw),
                     cfg.init_caches(8, 8, 2, dtype=torch.float32), "warmup",
                     None, None, None, 0)
        b, _ = plain(T(xw), torch.tensor([261]), T(ctx[:1]), T(dw),
                     cfg.init_caches(8, 8, 2, dtype=torch.float32), "warmup",
                     None, None, None, 0)
        assert rel_err(a.numpy(), b.numpy()) > 1e-3
        win = tsm.init_window_state(2)
        xs, ds = streams[0]
        outs = [m(T(xs), torch.tensor([261, 61]), T(ctx), T(ds),
                  cfg.init_caches(8, 8, 2, dtype=torch.float32), "stream",
                  tsm.mask_to_bias(win[0]), win[1], win[2])[0] for m in (tunet, plain)]
        assert torch.equal(outs[0], outs[1])


def test_cross_frame_config_builds_and_streams_on_cpu():
    """The reference config key reaches the UNet through build_pipeline."""
    from live2diff_tpu_torch.builder import build_pipeline

    config = {"t_index_list": [30, 40],
              "unet_additional_kwargs": {"unet_use_cross_frame_attention": True}}
    built = build_pipeline(config, 64, 64, dtype=torch.float32, kv_cache_dtype="int8",
                           output_uint8=True, device="cpu", unet_overrides=dict(TINY_UNET),
                           use_depth=False, use_lcm_lora=False)
    assert built.unet.config.unet_use_cross_frame_attention is True
    attn1 = built.unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1
    assert attn1.cross_frame
    state, warm = built.stream.prepare(torch.rand(8, 64, 64, 3) * 2 - 1,
                                       torch.randn(1, PROMPT_LEN, 12), seed=3)
    for _ in range(2):
        state, out = built.stream(state, torch.randint(0, 256, (64, 64, 3), dtype=torch.uint8))
    assert out.shape == (64, 64, 3) and out.dtype == torch.uint8
