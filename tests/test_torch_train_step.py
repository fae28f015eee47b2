"""The training step against the JAX package on the CPU: the clip-mode
temporal attention and UNet, ``diffusion_loss`` and every motion
parameter's gradient against ``jax.value_and_grad`` of
``diffusion_loss_fn``, and the parameters after one AdamW step against
``make_train_step(unet, make_optimizer(), mesh=None)``.

One JAX program computes all the references (one compile): JAX's step and
the clip-mode UNet forward. The step's gradient is ``jax.value_and_grad``
of ``diffusion_loss_fn`` inside ``make_train_step``; it is read back from
the first AdamW moment the step leaves, ``mu = (1 - b1) g`` with b1 = 0.9
(``g = mu / 0.1``, within an ulp). The step's t and noise are JAX's draws
(``jax.random.split`` as in ``live2diff_tpu/parallel/train.py:69-71``)
replayed into the port. The UNet is the tiny one of the parity tests with
one resnet a down block (half the modules, so the JAX program compiles in
about half the time).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import TINY_UNET, random_params_like, rel_err
from live2diff_tpu.models.motion import TemporalAttention as JaxTemporalAttention
from live2diff_tpu.models.unet import UNet3DConditionModel as JaxUNet
from live2diff_tpu.models.unet import UNetConfig as JaxUNetConfig
from live2diff_tpu.parallel.train import TrainState as JaxTrainState
from live2diff_tpu.parallel.train import make_optimizer as jax_make_optimizer
from live2diff_tpu.parallel.train import make_train_step as jax_make_train_step
from live2diff_tpu_torch.convert.from_jax import params_from_jax
from live2diff_tpu_torch.models.motion import TemporalAttention
from live2diff_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from live2diff_tpu_torch.parallel.train import (
    TrainState, alphas_cumprod, diffusion_loss, is_motion_param, make_optimizer,
    make_train_step,
)

TINY = dict(TINY_UNET, layers_per_block=1)  # cond_mapping: the depth branch is built
B, F, LAT, L = 2, 4, 8, 7
LR, WD = 1e-3, 0.01
# fp32 on both sides, sums in other orders: the loss within 1e-5, each
# gradient tensor within 1e-4 of its largest element, the clip-mode UNet
# output within 1e-4 of its largest
LOSS_TOL, GRAD_TOL, OUT_TOL = 1e-5, 1e-4, 1e-4


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


@pytest.fixture(scope="module")
def ref():
    rs = np.random.RandomState(0)
    latents = rs.randn(B, F, LAT, LAT, 4).astype(np.float32)
    text = rs.randn(B, L, 12).astype(np.float32)
    depth = rs.randn(B, F, LAT, LAT, 4).astype(np.float32)
    sample = rs.randn(B, F, LAT, LAT, 4).astype(np.float32)
    t_fwd = np.array([17, 803], np.int32)

    cfg = JaxUNetConfig(**TINY)
    unet = JaxUNet(config=cfg, dtype=jnp.float32)
    caches = tuple(jnp.zeros((0,), jnp.float32) for _ in range(cfg.num_caches()))
    shapes = jax.eval_shape(lambda: unet.init(
        jax.random.PRNGKey(0), jnp.asarray(latents), jnp.zeros((B,), jnp.int32),
        jnp.asarray(text), jnp.asarray(depth), caches, "clip", None, None, None))
    params = random_params_like(shapes, seed=3)
    optimizer = jax_make_optimizer(LR, WD)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=optimizer.init(params), rng=jax.random.PRNGKey(7))
    step = jax_make_train_step(unet, optimizer, mesh=None)
    batch = {"latents": jnp.asarray(latents), "text": jnp.asarray(text),
             "depth": jnp.asarray(depth)}

    def run(state, batch, sample):
        new_state, loss = step(state, batch)
        pred, out_caches = unet.apply(state.params, sample, jnp.asarray(t_fwd), batch["text"],
                                      None, caches, "clip", None, None, None)
        return new_state, loss, pred, out_caches

    new_state, loss, pred, out_caches = jax.jit(run)(state, batch, jnp.asarray(sample))
    # the step's draws, replayed: parallel/train.py:100 then :69-71
    _, step_rng = jax.random.split(jax.random.PRNGKey(7))
    r_t, r_noise = jax.random.split(step_rng)
    t = np.asarray(jax.random.randint(r_t, (B,), 0, 1000))
    noise = np.asarray(jax.random.normal(r_noise, latents.shape, jnp.float32))
    flat = lambda tree: {k: v.numpy() for k, v in params_from_jax(tree).items()}  # noqa: E731
    return dict(
        params=params, new=flat(new_state.params), grads=flat(_gradient_from_first_moment(new_state)),
        loss=float(loss), pred=np.asarray(pred), out_caches=out_caches,
        latents=latents, text=text, depth=depth, sample=sample, t_fwd=t_fwd, t=t,
        noise=noise)


def _gradient_from_first_moment(state) -> dict:
    """The step's gradient over the trained parameters, from AdamW's first
    moment ``mu = 0.1 g`` (the frozen parameters' masked nodes dropped)."""
    adam = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1

    def keep(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                if keep(v):
                    out[k] = keep(v)
            elif not isinstance(v, optax.MaskedNode):
                out[k] = np.asarray(v) / 0.1
        return out

    return keep(adam[0].mu)


def _port_unet(ref):
    unet = UNet3DConditionModel(UNetConfig(**TINY))
    unet.load_state_dict(params_from_jax(ref["params"]), strict=True)
    return unet


@pytest.fixture(scope="module")
def port_step(ref):
    """One port train step from the same weights, with JAX's t and noise."""
    unet = _port_unet(ref)
    before = {n: p.detach().clone() for n, p in unet.named_parameters()}
    optimizer = make_optimizer(unet, LR, WD)
    state = TrainState(step=0, unet=unet, optimizer=optimizer, generator=torch.Generator())
    batch = {"latents": _t(ref["latents"]), "text": _t(ref["text"]), "depth": _t(ref["depth"])}
    state, loss = make_train_step(unet, optimizer)(
        state, batch, t=torch.tensor(ref["t"]).long(), noise=_t(ref["noise"]))
    return state, float(loss), before


def test_clip_mode_temporal_attention_matches_jax():
    rs = np.random.RandomState(1)
    c, heads = 16, 2
    x = rs.randn(2, 6, 5, c).astype(np.float32)  # [B, HW, F, C]
    jmod = JaxTemporalAttention(query_dim=c, heads=heads)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), None,
                                              "clip"))
    params = random_params_like(shapes, seed=4)
    j_out, j_cache = jmod.apply(params, jnp.asarray(x), None, "clip")
    mod = TemporalAttention(c, heads)
    mod.load_state_dict(params_from_jax(params), strict=True)
    cache = (torch.zeros(0),)
    out, new_cache = mod(_t(x), cache, "clip")
    assert j_cache is None and new_cache is cache
    assert rel_err(out.detach().numpy(), j_out) < OUT_TOL


def test_clip_mode_unet_matches_jax(ref):
    unet = _port_unet(ref)
    cfg = unet.config
    caches = tuple(torch.zeros(0) for _ in range(cfg.num_caches()))
    with torch.no_grad():
        pred, out_caches = unet(_t(ref["sample"]), torch.from_numpy(ref["t_fwd"]).long(),
                                _t(ref["text"]), None, caches, "clip")
    assert rel_err(pred.numpy(), ref["pred"]) < OUT_TOL
    # the caches come back as they were passed, in both
    assert all(a is b for a, b in zip(out_caches, caches))
    assert all(np.asarray(c).shape == (0,) for c in ref["out_caches"])


def test_diffusion_loss_matches_jax(ref, port_step):
    _, loss, _ = port_step
    assert abs(loss - ref["loss"]) <= LOSS_TOL * abs(ref["loss"])
    # the loss alone, without a step, from the same draws
    unet = _port_unet(ref)
    batch = {"latents": _t(ref["latents"]), "text": _t(ref["text"]), "depth": _t(ref["depth"])}
    with torch.no_grad():
        alone = diffusion_loss(unet, batch, alphas_cumprod(), t=torch.tensor(ref["t"]).long(),
                               noise=_t(ref["noise"]))
    assert abs(float(alone) - ref["loss"]) <= LOSS_TOL * abs(ref["loss"])


def test_every_motion_gradient_matches_jax(ref, port_step):
    state, _, _ = port_step
    motion = [(n, p) for n, p in state.unet.named_parameters() if is_motion_param(n)]
    assert len(motion) > 50
    assert set(ref["grads"]) == {n for n, _ in motion}
    for name, p in motion:
        g_ref = ref["grads"][name]
        assert np.abs(g_ref).max() > 0, name  # random weights: no gradient is zero
        err = np.abs(p.grad.numpy() - g_ref).max() / np.abs(g_ref).max()
        assert err < GRAD_TOL, (name, err)


def test_frozen_parameters_get_no_gradient_and_stay(ref, port_step):
    state, _, before = port_step
    frozen = [(n, p) for n, p in state.unet.named_parameters() if not is_motion_param(n)]
    assert any(n.startswith("flow_conv_in.") for n, _ in frozen)  # the depth branch ran
    for name, p in frozen:
        assert not p.requires_grad and p.grad is None, name
        assert torch.equal(p.detach(), before[name]), name
        # and JAX's optax.set_to_zero leaves them where they were
        np.testing.assert_array_equal(ref["new"][name], before[name].numpy())
    assert state.step == 1


def test_one_adamw_step_matches_jax(ref, port_step):
    """AdamW's first step is lr * (g / (|g| + eps) + wd * p): about lr times
    the gradient's sign. Where |g| is below the two sides' gradient
    difference (noise at the level of GRAD_TOL), the signs may differ, and
    the parameters with them, by up to 2 lr; everywhere else they agree to
    fp32 rounding."""
    state, _, before = port_step
    for name, p in state.unet.named_parameters():
        if not is_motion_param(name):
            continue
        new, ref_new, g = p.detach().numpy(), ref["new"][name], ref["grads"][name]
        diff = np.abs(new - ref_new)
        assert diff.max() <= 2 * LR * (1 + 1e-3), name
        clear = np.abs(g) > 10 * GRAD_TOL * np.abs(g).max()
        assert diff[clear].max(initial=0.0) < 1e-6, name
        moved = np.abs(new - before[name].numpy())
        assert moved[clear].min(initial=LR) > 0.5 * LR, name
