"""Tensor parallelism on the CPU: the sharding rules at full width, and two
gloo ranks at tp = 2 against one process and against the JAX package.

The rules (``parallel/tp.py``) are checked on ``UNetConfig()`` built on the
``meta`` device (no memory) at tp = 2, 4 and 8, as the JAX package's
``flagship_stream_tp_check`` checks its ``_TP_RULES``: at least 60 % of the
parameter bytes on tp, and here also at least 90 % of the attention and
feed-forward projections' bytes. Every block is cut whole or kept whole.

One spawn of two ranks (``tests/_torch_tp_ranks.py``) computes, at
(dp, tp) = (1, 2) unless stated:

* a GEGLU feed-forward: each rank's ``net.0.proj`` holds its slab of both
  the hidden and the gate half; the output equals the unsharded one;
* the tiny UNet's stream (fp32 cache): the warmup, then 4 frames through
  the window state; within 1e-5 of one process (the row-parallel sums add
  in another order) with each rank's caches the channel slab of the
  unsharded caches, and within 1e-4 of the JAX package's unsharded
  ``unet.apply`` on the same weights (which is what its GSPMD step
  computes; the port's unsharded UNet is within 5e-5 of it,
  tests/test_torch_models.py);
* one train step of the tiny UNet (one resnet a down block) at (1, 2) and
  at (2, 1), on JAX's draws of t and noise: the loss within 1e-6 and every
  motion gradient within 1e-4 of its largest element against one process
  (tests/test_torch_train_ddp.py's tolerances), and within 1e-5 and 1e-4
  against JAX's ``make_train_step`` (tests/test_torch_train_step.py's);
* checkpoints: the tp = 2 state saved, then resumed here at tp = 1, bit for
  bit; a tp = 1 save resumed at tp = 2, each rank's slabs bit-equal to the
  saved tensors' slabs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import PROMPT_LEN, caches_to_np, jax_unet, random_params_like, rel_err
from _torch_ranks import spawn
from _torch_tp_ranks import FF, LR, TINY_UNET, TRAIN_UNET, WD, moments, train_state
from live2diff_tpu.models.unet import UNet3DConditionModel as JaxUNet
from live2diff_tpu.models.unet import UNetConfig as JaxUNetConfig
from live2diff_tpu.parallel.train import TrainState as JaxTrainState
from live2diff_tpu.parallel.train import make_optimizer as jax_make_optimizer
from live2diff_tpu.parallel.train import make_train_step as jax_make_train_step
from live2diff_tpu.stream.state_machine import (
    init_window_state, mask_to_bias, update_window_state,
)
from live2diff_tpu_torch.convert.from_jax import params_from_jax
from live2diff_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from live2diff_tpu_torch.parallel.checkpoint import (
    STATE_FILE, restore_train_state, save_train_state,
)
from live2diff_tpu_torch.parallel.infer import cache_sharding, run_stream
from live2diff_tpu_torch.parallel.mesh import Mesh
from live2diff_tpu_torch.parallel.tp import (
    COLUMN, GEGLU, ROW, param_sharding_spec, sharded_fraction, take_slab, tp_plan,
)
from live2diff_tpu_torch.parallel.train import is_motion_param, make_train_step

FRAMES, B, F, LAT = 4, 2, 4, 8
STREAM_TOL, JAX_STREAM_TOL = 1e-5, 1e-4
LOSS_TOL, GRAD_TOL = 1e-6, 1e-4  # against one process (tests/test_torch_train_ddp.py)
JAX_LOSS_TOL = 1e-5  # against JAX (tests/test_torch_train_step.py)
PROJECTIONS = r"(to_q|to_k|to_v|to_out\.0|ff\.net\.0\.proj|ff\.net\.2)\.weight$"


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


@pytest.fixture(scope="module")
def full_width():
    with torch.device("meta"):
        return UNet3DConditionModel(UNetConfig())


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_rules_shard_the_full_width_unet(full_width, tp):
    layout = tp_plan(full_width, tp)
    assert sharded_fraction(full_width, layout, PROJECTIONS) >= 0.90
    assert sharded_fraction(full_width, layout) >= 0.60
    # every attention, feed-forward and resnet block divides at SD-1.5's widths
    assert layout.blocks and all(layout.blocks.values())


@pytest.mark.parametrize("config,tp", [(UNetConfig(), 8), (UNetConfig(**TINY_UNET), 2),
                                       (UNetConfig(**TINY_UNET), 4), (UNetConfig(**TINY_UNET), 8)])
def test_every_block_is_cut_whole_or_kept_whole(config, tp):
    with torch.device("meta"):
        unet = UNet3DConditionModel(config)
    layout = tp_plan(unet, tp)
    modules = dict(unet.named_modules())
    for name, sharded in layout.blocks.items():
        named = [f"{name}.{p}" for p, _ in modules[name].named_parameters()
                 if param_sharding_spec(p)]
        assert named, name  # each block has parameters the rules cut
        assert all((n in layout.specs) == sharded for n in named), name
    # the tiny UNet: 2 heads a block and 4 groups a norm
    kinds = {type(modules[n]).__name__ for n, s in layout.blocks.items() if s}
    if config.block_out_channels[0] == 8:
        assert kinds == {2: {"CrossAttention", "TemporalAttention", "GEGLUFeedForward",
                             "ResnetBlock3D"},
                         4: {"GEGLUFeedForward", "ResnetBlock3D"},
                         8: {"GEGLUFeedForward"}}[tp]


def test_rules_name_the_diffusers_keys():
    cases = {"to_q.weight": COLUMN, "to_k.weight": COLUMN, "to_v.weight": COLUMN,
             "to_out.0.weight": ROW, "to_out.0.bias": None, "net.0.proj.weight": GEGLU,
             "net.0.proj.bias": GEGLU, "net.2.weight": ROW, "net.2.bias": None,
             "conv1.weight": COLUMN, "conv1.bias": COLUMN, "time_emb_proj.weight": COLUMN,
             "norm2.weight": COLUMN, "conv2.weight": ROW, "conv2.bias": None,
             "norm1.weight": None, "conv_shortcut.weight": None}
    for name, spec in cases.items():
        assert param_sharding_spec(name) == spec, name
    w = torch.arange(8.0)[:, None].expand(8, 3)
    assert torch.equal(take_slab(w, GEGLU, 1, 2)[:, 0], torch.tensor([2.0, 3.0, 6.0, 7.0]))
    assert torch.equal(take_slab(w.T, ROW, 0, 4), w.T[:, :2])


def _jax_stream(params, inputs):
    """The JAX package's unsharded warmup and stream frames."""
    unet = JaxUNet(config=JaxUNetConfig(**TINY_UNET), dtype=jnp.float32)
    apply = jax.jit(unet.apply, static_argnums=(6, 10))
    caches = JaxUNetConfig(**TINY_UNET).init_caches(LAT, LAT, 2, dtype=jnp.float32)
    j = {k: jnp.asarray(v.numpy()) for k, v in inputs.items()}
    for idx in range(2):
        _, caches = apply(params, j["warm_sample"], j["timesteps"][idx:idx + 1].astype(jnp.int32),
                          j["text"][:1], j["warm_depth"], caches, "warmup", None, None, None, idx)
    state = init_window_state(2)
    outs = []
    for sample, depth in zip(j["sample"], j["depth"]):
        out, caches = apply(params, sample, j["timesteps"].astype(jnp.int32), j["text"], depth,
                            caches, "stream", mask_to_bias(state[0]), state[1], state[2])
        outs.append(np.asarray(out))
        state = update_window_state(*state)
    return outs


def _jax_train(rs):
    """JAX's train step on the tiny UNet (one resnet a down block): its
    weights, batch, draws, loss and gradients (from AdamW's first moment,
    ``mu = 0.1 g``, as tests/test_torch_train_step.py reads them)."""
    batch = {"latents": rs.randn(B, F, LAT, LAT, 4), "text": rs.randn(B, PROMPT_LEN, 12),
             "depth": rs.randn(B, F, LAT, LAT, 4)}
    batch = {k: jnp.asarray(v.astype(np.float32)) for k, v in batch.items()}
    cfg = JaxUNetConfig(**TRAIN_UNET)
    unet = JaxUNet(config=cfg, dtype=jnp.float32)
    caches = tuple(jnp.zeros((0,), jnp.float32) for _ in range(cfg.num_caches()))
    shapes = jax.eval_shape(lambda: unet.init(
        jax.random.PRNGKey(0), batch["latents"], jnp.zeros((B,), jnp.int32), batch["text"],
        batch["depth"], caches, "clip", None, None, None))
    params = random_params_like(shapes, seed=3)
    optimizer = jax_make_optimizer(LR, WD)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=optimizer.init(params), rng=jax.random.PRNGKey(7))
    new_state, loss = jax.jit(jax_make_train_step(unet, optimizer, mesh=None))(state, batch)
    _, step_rng = jax.random.split(jax.random.PRNGKey(7))
    r_t, r_noise = jax.random.split(step_rng)
    t = np.asarray(jax.random.randint(r_t, (B,), 0, 1000))
    noise = np.asarray(jax.random.normal(r_noise, (B, F, LAT, LAT, 4), jnp.float32))
    adam = [s for s in jax.tree_util.tree_leaves(
        new_state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    mu = jax.tree_util.tree_map(lambda x: x if isinstance(x, optax.MaskedNode) else x / 0.1,
                                adam[0].mu, is_leaf=lambda x: isinstance(x, optax.MaskedNode))
    grads = {k: v.numpy() for k, v in params_from_jax(_drop_masked(mu)).items()}
    torch_batch = {k: _t(v) for k, v in batch.items()}
    torch_batch.update(t=torch.from_numpy(t.copy()).long(), noise=_t(noise))
    return params_from_jax(params), torch_batch, float(loss), grads


def _drop_masked(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            if _drop_masked(v):
                out[k] = _drop_masked(v)
        elif not isinstance(v, optax.MaskedNode):
            out[k] = v
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The references, then one spawn of two ranks; returns both sides."""
    out = tmp_path_factory.mktemp("tp")
    rs = np.random.RandomState(11)
    torch.manual_seed(0)
    ff = FF(16)
    ff_x = _t(rs.randn(3, 5, 16))

    params = jax_unet(seed=4)[1]
    stream_sd = params_from_jax(params)
    w = (1, 8, LAT, LAT, 4)
    each = (FRAMES, 2, 1, LAT, LAT, 4)
    inputs = {"warm_sample": _t(rs.randn(*w)), "warm_depth": _t(rs.randn(*w)),
              "text": _t(rs.randn(2, PROMPT_LEN, 12)), "sample": _t(rs.randn(*each)),
              "depth": _t(rs.randn(*each)), "timesteps": torch.tensor([261, 61])}
    single = UNet3DConditionModel(UNetConfig(**TINY_UNET))
    single.load_state_dict(stream_sd)
    caches = single.config.init_caches(LAT, LAT, 2, torch.float32)
    single_outs, single_caches, _ = run_stream(single.eval(), caches, inputs)

    train_sd, train_batch, jax_loss, jax_grads = _jax_train(rs)
    one = train_state(train_sd, Mesh())
    step = make_train_step(one.unet, one.optimizer, Mesh())
    one, loss = step(one, {k: train_batch[k] for k in ("latents", "text", "depth")},
                     t=train_batch["t"], noise=train_batch["noise"])
    motion = [(n, p) for n, p in one.unet.named_parameters() if is_motion_param(n)]
    save_train_state(str(out / "ckpt_tp1"), one)

    torch.save({"ff_sd": ff.state_dict(), "ff_x": ff_x, "stream_sd": stream_sd,
                "stream_inputs": inputs, "train_sd": train_sd, "train_batch": train_batch,
                "ckpt_tp1": str(out / "ckpt_tp1")}, out / "inputs.pt")
    spawn("_torch_tp_ranks", 2, str(out))
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=True) for r in range(2)]
    with torch.no_grad():
        ff_ref = ff(ff_x)
    return dict(
        out=out, ranks=ranks, ff=ff, ff_ref=ff_ref, stream_ref=single_outs,
        stream_caches=single_caches, jax_stream=_jax_stream(params, inputs),
        one={"loss": float(loss), "grads": {n: p.grad for n, p in motion},
             "params": {n: p.detach() for n, p in motion}},
        jax_loss=jax_loss, jax_grads=jax_grads, train_sd=train_sd)


def test_geglu_sharded_over_both_halves_equals_the_unsharded(run):
    w = run["ff"].ff.net[0].proj.weight.detach()  # [2 * 64, 16]: hidden rows, then gate rows
    for r, res in enumerate(run["ranks"]):
        assert torch.equal(res["ff_slab"], torch.cat([w[32 * r:32 * (r + 1)],
                                                      w[64 + 32 * r:64 + 32 * (r + 1)]]))
        assert rel_err(res["ff"].numpy(), run["ff_ref"].numpy()) < STREAM_TOL


def test_tp2_stream_matches_one_process_and_its_cache_slabs(run):
    for r, res in enumerate(run["ranks"]):
        for out, ref in zip(res["stream"], run["stream_ref"]):
            assert rel_err(out.numpy(), ref.numpy()) < STREAM_TOL, r
        slabs = cache_sharding(Mesh(1, 2, r), run["stream_caches"], UNetConfig(**TINY_UNET))
        for a, b in zip(caches_to_np(res["stream_caches"]), caches_to_np(slabs)):
            assert a.shape == b.shape and b.shape[3] * 2 in (8, 16)
            assert rel_err(a, b) < STREAM_TOL, r


def test_tp2_shards_keep_the_conv_weights_channels_last(run):
    """``shard_params`` lays the conv slabs out channels-last again, so the
    sharded stream (its row convs through ``partial_fp32``) counts no
    weight relayout."""
    for res in run["ranks"]:
        assert res["stream_conv_layouts"] and all(res["stream_conv_layouts"].values())
        assert res["stream_relayouts"] == 0


def test_tp2_stream_matches_the_jax_unsharded_apply(run):
    assert len(run["jax_stream"]) == FRAMES
    for out, ref in zip(run["ranks"][0]["stream"], run["jax_stream"]):
        assert rel_err(out.numpy(), ref) < JAX_STREAM_TOL


@pytest.mark.parametrize("layout", ["train_tp", "train_dp"])
def test_train_step_over_ranks_matches_one_process_and_jax(run, layout):
    one = run["one"]
    for res in run["ranks"]:
        got = res[layout]
        assert abs(got["loss"] - one["loss"]) <= LOSS_TOL * abs(one["loss"])
        assert abs(got["loss"] - run["jax_loss"]) <= JAX_LOSS_TOL * abs(run["jax_loss"])
        assert got["grads"].keys() == one["grads"].keys() == run["jax_grads"].keys()
        for name, g in one["grads"].items():
            ours = got["grads"][name]
            assert ours.shape == g.shape, name
            assert (ours - g).abs().max() <= GRAD_TOL * g.abs().max(), name
            ref = run["jax_grads"][name]
            assert np.abs(ours.numpy() - ref).max() <= GRAD_TOL * np.abs(ref).max(), name
    # the ranks hold one state
    a, b = (res[layout]["params"] for res in run["ranks"])
    assert all(torch.equal(a[n], b[n]) for n in a)


def test_tp2_checkpoint_resumes_at_tp1_bit_equal(run):
    saved = torch.load(run["out"] / "ckpt_tp2" / STATE_FILE, weights_only=True)
    ranked = run["ranks"][0]["train_tp"]
    state = train_state(run["train_sd"], Mesh())
    restore_train_state(str(run["out"] / "ckpt_tp2"), state)
    assert state.step == 1
    params = {n: p.detach() for n, p in state.unet.named_parameters() if is_motion_param(n)}
    assert params.keys() == ranked["params"].keys() == saved["motion"].keys()
    for name, p in params.items():
        assert torch.equal(p, ranked["params"][name]), name
    for name, m in moments(state).items():
        assert torch.equal(m, ranked["exp_avg"][name]), name


def test_tp1_checkpoint_resumes_at_tp2_bit_equal(run):
    saved = torch.load(run["out"] / "ckpt_tp1" / STATE_FILE, weights_only=True)
    with torch.device("meta"):
        layout = tp_plan(UNet3DConditionModel(UNetConfig(**TRAIN_UNET)), 2)
    assert any(is_motion_param(n) for n in layout.specs)
    by_index = dict(zip(saved["motion"], saved["optimizer"]["state"].values()))
    for r, res in enumerate(run["ranks"]):
        assert res["resumed_step"] == 1
        for name, full in saved["motion"].items():
            spec = layout.specs.get(name)
            want = full if spec is None else take_slab(full, spec, r, 2)
            assert torch.equal(res["resumed"][name], want), name
            m = by_index[name]["exp_avg"]
            want = m if spec is None else take_slab(m, spec, r, 2)
            assert torch.equal(res["resumed_exp_avg"][name], want), name
