"""SD-1.5's AutoencoderKL in the port against the JAX module, and its ingest.

Module parity at a narrow config (``block_out_channels=(8, 8, 16, 16)``,
4 groups, as tests/test_models.py builds it): ``encode`` (the mean, and a
sample with the JAX draw replayed) and ``decode`` in fp32 within 1e-4 of
JAX on the same weights. Ingest: a diffusers ``vae/`` state dict loads by
name with nothing missing, in today's names and in the older
``query``/``key``/``value``/``proj_attn`` ones (1x1-conv weights), and the
port's parameters equal what the JAX converter makes of the same dict.
GroupNorm: ``VAEGroupNorm`` (now ``ops/norm.py:group_norm_act`` with the
SiLU inside) against the formula it replaced (``F.group_norm`` in fp32, a
cast, then ``F.silu``), and its route: plain on the CPU, and, routed as on
an H100, the kernel only where its parameters are stored in x's dtype.
Pipeline parity: both builders read one set of synthetic checkpoints with
a ``vae/`` folder (tests/_torch_checkpoints.py), ``use_tiny_vae=False`` at
64x64 with the narrow VAE config put in place of ``VAEConfig()`` on both
sides (the full one is 83 M parameters), then ``prepare`` plus 6 frames with
the JAX noise replayed, within tests/test_torch_pipeline.py's fp32
tolerance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import live2diff_tpu.builder as jax_builder
import live2diff_tpu_torch.builder as port_builder
from _torch_checkpoints import (
    TINY_OVERRIDES, config_without_paths, draw, module_shapes, save_file, write_checkpoints,
)
from _torch_parity import random_params_like, rel_err, to_np
from live2diff_tpu.convert.torch_to_flax import vae_torch_to_flax
from live2diff_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from live2diff_tpu.models.vae import VAEConfig as JaxVAEConfig
from live2diff_tpu_torch.convert.checkpoint import build_module, vae_state_dict
from live2diff_tpu_torch.convert.from_jax import params_from_jax
from live2diff_tpu_torch.models.vae import (
    VAE_SITE, AutoencoderKL, VAEConfig, VAEGroupNorm, codec_route_counts,
)
from live2diff_tpu_torch.ops import norm as tnorm
from test_torch_pipeline import FP32_TOL, _frames, _normal, _Replay

NARROW = dict(block_out_channels=(8, 8, 16, 16), norm_num_groups=4)
SIZE = 32
# fp32 on both sides, the same math in another order
MODULE_TOL = 1e-4
OLD_NAMES = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


@pytest.fixture(scope="module")
def kl():
    """(flax module, its params, the port's module on the same weights)."""
    jv = JaxAutoencoderKL(config=JaxVAEConfig(**NARROW))
    shapes = jax.eval_shape(lambda: jv.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, SIZE, SIZE, 3))))
    params = random_params_like(shapes, 3)
    tv = AutoencoderKL(VAEConfig(**NARROW))
    tv.load_state_dict(params_from_jax(params), strict=True)
    return jv, params, tv.eval()


def _images(n=2, seed=0):
    return np.random.RandomState(seed).rand(n, SIZE, SIZE, 3).astype(np.float32) * 2 - 1


def test_encode_mean_matches_jax(kl):
    jv, params, tv = kl
    x = _images()
    ref = np.asarray(jv.apply(params, jnp.asarray(x), method=jv.encode))
    with torch.no_grad():
        ours = tv.encode(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (2, SIZE // 8, SIZE // 8, 4)
    assert rel_err(ours, ref) < MODULE_TOL


def test_encode_sample_matches_jax_replayed_draw(kl):
    """With an rng JAX adds exp(0.5 * clip(logvar)) * N(0, 1); the port's
    ``noise`` hands it the same draw."""
    jv, params, tv = kl
    x = _images(seed=1)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jv.apply(params, jnp.asarray(x), key, method=jv.encode))
    with torch.no_grad():
        mean = tv.encode(torch.from_numpy(x))
        ours = tv.encode(torch.from_numpy(x), noise=lambda shape: torch.from_numpy(
            np.array(_normal(key, shape)))).numpy()
    assert rel_err(ours, ref) < MODULE_TOL
    assert np.abs(ours - mean.numpy()).max() > 1e-3  # the sample is not the mean


def test_encode_with_a_generator_draws_from_it(kl):
    _, _, tv = kl
    x = torch.from_numpy(_images(seed=2))
    with torch.no_grad():
        a = tv.encode(x, generator=torch.Generator().manual_seed(4))
        b = tv.encode(x, generator=torch.Generator().manual_seed(4))
        c = tv.encode(x, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_decode_matches_jax(kl):
    jv, params, tv = kl
    z = np.random.RandomState(3).randn(2, SIZE // 8, SIZE // 8, 4).astype(np.float32)
    ref = np.asarray(jv.apply(params, jnp.asarray(z), method=jv.decode))
    with torch.no_grad():
        ours = tv.decode(torch.from_numpy(z)).numpy()
    assert ours.shape == ref.shape == (2, SIZE, SIZE, 3)
    assert rel_err(ours, ref) < MODULE_TOL


def _bf16_ulp(a: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 (8 significant bits) at |a|, at least 2^-16."""
    _, e = torch.frexp(a.abs().clamp_min(2.0 ** -8))
    return torch.ldexp(torch.ones_like(a), e - 8)


def _norm_module(c, act, dtype, seed):
    torch.manual_seed(seed)
    m = VAEGroupNorm(4 if c < 64 else 32, c, act)
    with torch.no_grad():
        m.weight.copy_(1 + 0.2 * torch.randn(c))
        m.bias.copy_(0.3 * torch.randn(c))
    return m.to(dtype).eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("act", ["none", "silu"])
def test_group_norm_matches_the_formula_it_replaced(dtype, act):
    """The module against ``F.group_norm`` over an fp32 NCHW copy, cast to
    x's dtype, then ``F.silu``: in fp32 within fp32 rounding (the sums run
    in other orders); in bf16 within one bf16 ulp of the normalised value,
    the one rounding the old formula made before its SiLU and the new one
    does not. On the CPU each call runs plain and counts so."""
    for seed, (n, h, w, c) in enumerate([(2, 16, 16, 64), (1, 32, 32, 128), (1, 8, 8, 512),
                                         (1, 12, 10, 24)]):
        m = _norm_module(c, act, dtype, seed)
        x = (torch.randn(n, h, w, c) * 3 + 1).to(dtype)
        codec, routes = dict(codec_route_counts), dict(tnorm.norm_route_counts)
        with torch.no_grad():
            out = m(x)
            pre = F.group_norm(x.float().permute(0, 3, 1, 2), m.num_groups, m.weight.float(),
                               m.bias.float(), 1e-6).permute(0, 2, 3, 1)
        old = pre.to(dtype)
        old = F.silu(old) if act == "silu" else old
        assert out.shape == x.shape and out.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(out, old, rtol=1e-5, atol=1e-5 * old.abs().max().item())
        else:
            assert ((out.float() - old.float()).abs() <= _bf16_ulp(pre)).all()
        assert codec_route_counts["kl_group_norm"] == codec["kl_group_norm"] + 1
        assert codec_route_counts["kl_group_norm_kernel"] == codec["kl_group_norm_kernel"]
        assert tnorm.norm_route_counts["gn_plain"] == routes["gn_plain"] + 1


def test_group_norm_takes_the_kernel_on_the_card(monkeypatch):
    """Routed as a bf16 call on an H100 would be (``gn_route`` told the device
    is a card; on the CPU the kernel's wrapper runs its plain version), the
    module takes the kernel; the output is the plain version's, and the
    codec counts the route."""
    real_route, real_gn = tnorm.gn_route, tnorm.group_norm
    sites, launches = [], []

    def as_on_card(t, c, groups, dtype, device_type, grad, site, *args, **kw):
        sites.append(site)
        return real_route(t, c, groups, dtype, "cuda", grad, site, *args,
                          **{**kw, "smem_bytes": 232448})

    monkeypatch.setattr(tnorm, "gn_route", as_on_card)
    monkeypatch.setattr(tnorm, "group_norm",
                        lambda *a, **kw: (launches.append(a[0].shape), real_gn(*a, **kw))[1])
    m = _norm_module(128, "silu", torch.bfloat16, 7)
    x = (torch.randn(1, 16, 16, 128) * 3 + 1).to(torch.bfloat16)
    codec = dict(codec_route_counts)
    with torch.no_grad():
        out = m(x)
    assert set(sites) == {VAE_SITE}
    assert launches == [(1, 256, 128)]
    assert codec_route_counts["kl_group_norm_kernel"] == codec["kl_group_norm_kernel"] + 1
    assert codec_route_counts["kl_group_norm"] == codec["kl_group_norm"] + 1
    ref = tnorm.group_norm_plain(x.reshape(1, 256, 128), m.weight, m.bias, 32, 1e-6, "silu")
    assert torch.equal(out, ref.reshape(x.shape))


def _diffusers_vae(seed=0, old_names=False, conv_shaped=False):
    """A complete diffusers ``vae/`` state dict of the narrow config (numpy);
    with ``old_names`` the mid-block attentions take the older names, with
    ``conv_shaped`` their weights ``[C, C, 1, 1]`` too."""
    rs = np.random.RandomState(seed)
    sd = {k: draw(k, s, rs)
          for k, s in module_shapes(lambda: AutoencoderKL(VAEConfig(**NARROW))).items()}
    if old_names:
        for key in [k for k in sd if ".attentions." in k and "group_norm" not in k]:
            stem, name, leaf = key.rsplit(".", 2) if "to_out" not in key else (
                key[: key.index(".to_out")], "to_out.0", key.rsplit(".", 1)[1])
            val = sd.pop(key)
            if leaf == "weight" and conv_shaped:
                val = val[:, :, None, None]
            sd[f"{stem}.{OLD_NAMES[name]}.{leaf}"] = val
    return sd


def _load(sd):
    missing = []
    tv = build_module(lambda: AutoencoderKL(VAEConfig(**NARROW)), torch.device("cpu"),
                      torch.float32, torch.Generator(), vae_state_dict(
                          {k: torch.from_numpy(v) for k, v in sd.items()}), missing)
    return tv.state_dict(), missing


@pytest.mark.parametrize("old_names", [False, True])
def test_diffusers_state_dict_loads_by_name(old_names):
    """Every parameter from its own key (nothing missing, nothing drawn),
    equal to the JAX converter's reading of the same dict."""
    sd = _diffusers_vae(old_names=old_names)
    assert any(".query." in k for k in sd) == old_names
    ours, missing = _load(sd)
    assert missing == []
    converted, skipped = vae_torch_to_flax(sd)
    assert skipped == []
    ref = params_from_jax(converted)
    assert set(ours) == set(ref)
    assert [k for k, v in ours.items() if not torch.equal(v, ref[k])] == []
    plain = _diffusers_vae()
    assert torch.equal(ours["decoder.mid_block.attentions.0.to_out.0.weight"],
                       torch.from_numpy(plain["decoder.mid_block.attentions.0.to_out.0.weight"]))


def test_older_names_with_1x1_conv_weights_load_squeezed():
    """``[C, C, 1, 1]`` projection weights under the older names load as
    the linears' ``[C, C]`` (the JAX converter transposes them as 2-D and
    raises on them, so the port is held to the 2-D file instead)."""
    ours, missing = _load(_diffusers_vae(old_names=True, conv_shaped=True))
    ref, _ = _load(_diffusers_vae(old_names=True))
    assert missing == []
    assert all(torch.equal(v, ref[k]) for k, v in ours.items())


# ---------------------------------------------------------------------------
# the pipeline: both builders, use_tiny_vae=False
# ---------------------------------------------------------------------------

H = W = 64
LH, LW = H // 8, W // 8
WARM, N_FRAMES, STEPS, SEED = 8, 6, 2, 5


@pytest.fixture(scope="module")
def kl_builds(tmp_path_factory):
    ckpt = write_checkpoints(tmp_path_factory.mktemp("kl_ckpt"))
    base = ckpt["pretrained_model_path"]
    import os

    os.makedirs(f"{base}/vae")
    # older names in the base folder; the DreamBooth VAE part
    # (encoder.conv_in.weight) overrides its key
    save_file(_diffusers_vae(seed=11, old_names=True),
              f"{base}/vae/diffusion_pytorch_model.safetensors")
    cfg = config_without_paths(ckpt)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_builder, "VAEConfig", lambda: JaxVAEConfig(**NARROW))
        mp.setattr(port_builder, "VAEConfig", lambda: VAEConfig(**NARROW))
        jb = jax_builder.build_pipeline(dict(cfg), height=H, width=W, use_depth=False,
                                        use_tiny_vae=False, unet_overrides=TINY_OVERRIDES,
                                        dtype=jnp.float32)
        tb = port_builder.build_pipeline(dict(cfg), H, W, dtype=torch.float32, device="cpu",
                                         use_depth=False, use_tiny_vae=False,
                                         unet_overrides=TINY_OVERRIDES)
    return ckpt, jb, tb


def test_kl_weights_equal_jax_and_dreambooth_overrides(kl_builds):
    ckpt, jb, tb = kl_builds
    assert isinstance(tb.vae, AutoencoderKL)
    ours = tb.vae.state_dict()
    ref = params_from_jax(jb.stream.params["vae"])
    assert set(ours) == set(ref)
    assert [k for k, v in ours.items() if not torch.equal(v, ref[k])] == []
    assert not any(m.startswith(("param:", "shape-mismatch:")) for m in tb.missing_artifacts)
    from live2diff_tpu_torch.convert.state_dict import load_state_dict_file

    db = load_state_dict_file(ckpt["paths"]["dreambooth"])
    assert torch.equal(ours["encoder.conv_in.weight"],
                       db["first_stage_model.encoder.conv_in.weight"])
    assert tb.stream.cfg.vae_scaling == jb.stream.cfg.vae_scaling == 0.18215


def test_kl_stream_matches_jax(kl_builds):
    """prepare + 6 frames, fp32 caches, the JAX draws replayed."""
    _, jb, tb = kl_builds
    jpipe, tpipe = jb.stream, tb.stream
    frames = _frames()[:WARM + N_FRAMES]
    prompt = np.random.RandomState(23).randn(1, 7, 12).astype(np.float32)
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
        pairs.append((to_np(tout), np.asarray(jout)))
    for i, (ours, ref) in enumerate(pairs):
        assert np.isfinite(ours).all() and ours.shape == ref.shape
        assert rel_err(ours, ref) < FP32_TOL, f"frame {i - 1}: {rel_err(ours, ref):.2e}"
