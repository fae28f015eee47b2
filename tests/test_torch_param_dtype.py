"""``build_pipeline(..., param_dtype=)``: parameters stored in one dtype,
computed in another, against the JAX builder.

Both builders ingest one set of synthetic checkpoints
(tests/_torch_checkpoints.py, the tiny UNet of tests/conftest.py) with
``dtype`` and ``param_dtype`` apart, both ways round. The JAX parameter
tree, carried by ``params_from_jax`` in its own dtype, must equal the
port's parameters bit for bit and in dtype. Then one UNet call and a
prepare plus a few stream frames (the JAX draws replayed into the port)
are held to the JAX outputs:

* ``dtype=float32, param_dtype=bfloat16``: both compute in fp32 on
  bf16-valued weights, so fp32 bounds hold: 1e-5 relative RMS on the UNet
  call (measured 8.7e-7), 2e-5 on the stream's outputs (1.9e-6 to 6.3e-6).
* ``dtype=bfloat16, param_dtype=float32``: both compute in bf16; XLA and
  torch round the bf16 intermediates apart, which this tiny UNet (weights
  N(0, 1/fan_in)) spreads: the UNet call measured 2.6e-2 relative RMS and
  the stream 2.3e-2 to 4.1e-2, as with bf16 parameters on both sides
  (2.9e-2 on the same call). Bound 0.1: bf16 noise, not a check of the
  rounding. That check is per layer (``test_layers_apply_fp32_params_at_
  bf16_as_jax_does``): a norm's output is the JAX module's element for
  element, a linear layer's the bf16-rounded weight's bit for bit.

With ``param_dtype`` left out or equal to ``dtype`` nothing changes: the
same parameters, bit-equal outputs, and not one op more in a stream step
(no parameter is cast).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_checkpoints import TINY_OVERRIDES, config_without_paths, write_checkpoints
from _torch_parity import to_np
from live2diff_tpu.builder import build_pipeline as jax_build_pipeline
from live2diff_tpu.stream.state_machine import init_window_state, mask_to_bias
from live2diff_tpu_torch.builder import build_pipeline
from live2diff_tpu_torch.convert.from_jax import params_from_jax
from live2diff_tpu_torch.models import layers
from test_torch_pipeline import _frames, _normal, _Replay

H = W = 64
LH, LW = H // 8, W // 8
WARM, N_FRAMES, STEPS, SEED = 8, 3, 2, 5
PROMPT_LEN, CTX = 7, 12

# (dtype, param_dtype, UNet bound, stream bound), relative RMS
PAIRS = {
    "fp32_compute_bf16_params": (torch.float32, torch.bfloat16, 1e-5, 2e-5),
    "bf16_compute_fp32_params": (torch.bfloat16, torch.float32, 1e-1, 1e-1),
}
_JAX = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def rel_rms(ours, ref) -> float:
    a, b = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / (np.mean(b ** 2) + 1e-30)))


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    return config_without_paths(write_checkpoints(tmp_path_factory.mktemp("ckpt")))


@pytest.fixture(scope="module", params=list(PAIRS))
def builds(request, cfg):
    """(pair, JAX build, port build) of each pair, built once."""
    dtype, param_dtype, *_ = PAIRS[request.param]
    jb = jax_build_pipeline(dict(cfg), height=H, width=W, use_depth=False,
                            unet_overrides=TINY_OVERRIDES, dtype=_JAX[dtype],
                            param_dtype=_JAX[param_dtype])
    tb = build_pipeline(dict(cfg), H, W, dtype=dtype, param_dtype=param_dtype, device="cpu",
                        use_depth=False, unet_overrides=TINY_OVERRIDES)
    return request.param, jb, tb


def test_parameters_are_the_jax_builders_in_param_dtype(builds):
    pair, jb, tb = builds
    param_dtype = PAIRS[pair][1]
    for ours_module, tree in ((tb.unet, jb.unet_params), (tb.vae, jb.stream.params["vae"])):
        ref = params_from_jax(tree)
        ours = ours_module.state_dict()
        assert set(ours) == set(ref)
        assert {v.dtype for v in ref.values()} == {v.dtype for v in ours.values()} \
            == {param_dtype}
        assert [k for k, v in ours.items() if not torch.equal(v, ref[k])] == []


def test_unet_call_matches_jax(builds):
    """One stream-mode UNet call on the 2-step batch, fp32 caches."""
    pair, jb, tb = builds
    dtype, _, bound, _ = PAIRS[pair]
    rs = np.random.RandomState(3)
    x, depth = (rs.randn(STEPS, 1, LH, LW, 4).astype(np.float32) for _ in range(2))
    ctx = rs.randn(STEPS, PROMPT_LEN, CTX).astype(np.float32)
    t = np.array([801, 261])
    mask, pe_idx, update_idx = init_window_state(STEPS)
    jc = jb.unet.config.init_caches(LH, LW, STEPS, dtype=jnp.float32)
    jc = [c + 0.1 * jnp.asarray(rs.randn(*c.shape).astype(np.float32)) for c in jc]
    tc = tuple(torch.from_numpy(np.array(c)) for c in jc)
    jdt = _JAX[dtype]
    ref, _ = jax.jit(jb.unet.apply, static_argnums=(6,))(
        jb.unet_params, jnp.asarray(x, jdt), jnp.asarray(t), jnp.asarray(ctx, jdt),
        jnp.asarray(depth, jdt), jc, "stream", mask_to_bias(mask), pe_idx, update_idx)
    bias = torch.from_numpy(np.array(mask_to_bias(mask)))
    with torch.no_grad():
        out, _ = tb.unet(torch.from_numpy(x).to(dtype), torch.from_numpy(t),
                         torch.from_numpy(ctx).to(dtype), torch.from_numpy(depth).to(dtype),
                         tc, "stream", bias, torch.from_numpy(np.array(pe_idx)),
                         torch.from_numpy(np.array(update_idx)))
    assert out.dtype == dtype
    assert np.isfinite(_f32(out)).all()
    assert rel_rms(_f32(out), _f32(ref)) < bound


def test_stream_matches_jax(builds):
    """prepare + 3 frames, fp32 latents, the JAX draws replayed."""
    pair, jb, tb = builds
    bound = PAIRS[pair][3]
    frames = _frames()[:WARM + N_FRAMES]
    prompt = np.random.RandomState(23).randn(1, PROMPT_LEN, CTX).astype(np.float32)
    jstate, jwarm = jb.stream.prepare(frames[:WARM], jnp.asarray(prompt), seed=SEED)
    rng, r_enc = jax.random.split(jax.random.PRNGKey(SEED))
    draws = [_normal(r_enc, (WARM, LH, LW, 4))]
    for _ in range(STEPS - 1):
        rng, r = jax.random.split(rng)
        draws.append(_normal(r, (WARM, LH, LW, 4)))
    tstate, twarm = tb.stream.prepare(torch.from_numpy(frames[:WARM]),
                                      torch.from_numpy(prompt), noise=_Replay(draws))
    pairs = [(to_np(twarm), np.asarray(jwarm))]
    for frame in frames[WARM:]:
        _, r_enc, r_buf = jax.random.split(jstate.rng, 3)
        replay = _Replay([_normal(r_enc, (1, LH, LW, 4)),
                          _normal(r_buf, (STEPS - 1, LH, LW, 4))])
        jstate, jout = jb.stream(jstate, frame)
        tstate, tout = tb.stream(tstate, torch.from_numpy(frame), noise=replay)
        pairs.append((to_np(tout), np.asarray(jout)))
    for i, (ours, ref) in enumerate(pairs):
        assert np.isfinite(ours).all() and ours.shape == ref.shape
        err = rel_rms(ours, ref)
        assert err < bound, f"{'warmup' if i == 0 else f'frame {i - 1}'}: {err:.2e}"


class _ParamCasts(TorchDispatchMode):
    """Counts the ops run, and the casts of a parameter to the compute dtype
    (the plain norms' fp32 casts of a bf16 scale are not such casts)."""

    def __init__(self, params, dtype):
        super().__init__()
        self.ptrs = {p.data_ptr() for p in params}
        self.dtype = dtype
        self.ops = 0
        self.param_casts = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        if (func is torch.ops.aten._to_copy.default and args[0].data_ptr() in self.ptrs
                and kwargs.get("dtype") == self.dtype):
            self.param_casts += 1
        return func(*args, **kwargs)


def _step_trace(built, frames, prompt):
    """Outputs of prepare + 2 frames (seed 7), and the ops of the last step."""
    params = [p for m in (built.unet, built.vae) for p in m.parameters()]
    state, warm = built.stream.prepare(torch.from_numpy(frames[:WARM]),
                                       torch.from_numpy(prompt), seed=7)
    outs = [warm]
    state, out = built.stream(state, torch.from_numpy(frames[WARM]))
    outs.append(out)
    mode = _ParamCasts(params, built.stream.dtype)
    with mode:
        state, out = built.stream(state, torch.from_numpy(frames[WARM + 1]))
    outs.append(out)
    return outs, mode


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_param_dtype_equal_to_dtype_changes_nothing(dtype):
    """Left out or equal to ``dtype``: the same weights, bit-equal outputs,
    the same ops a step and no parameter cast; apart, the step casts."""
    kw = dict(height=H, width=W, dtype=dtype, device="cpu", use_depth=False,
              unet_overrides=TINY_OVERRIDES, seed=3)
    frames = _frames()[:WARM + 2]
    prompt = np.random.RandomState(5).randn(1, PROMPT_LEN, CTX).astype(np.float32)
    config = {"t_index_list": [30, 40]}
    old = build_pipeline(config, **kw)
    same = build_pipeline(config, param_dtype=dtype, **kw)
    for a, b in ((old.unet, same.unet), (old.vae, same.vae)):
        assert all(torch.equal(x, y) and x.dtype == dtype == y.dtype
                   for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    outs_old, ops_old = _step_trace(old, frames, prompt)
    outs_same, ops_same = _step_trace(same, frames, prompt)
    assert all(torch.equal(a, b) for a, b in zip(outs_old, outs_same))
    assert ops_same.ops == ops_old.ops and ops_old.param_casts == ops_same.param_casts == 0

    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    apart = build_pipeline(config, param_dtype=other, **kw)
    _, ops_apart = _step_trace(apart, frames, prompt)
    assert ops_apart.param_casts > 0


def _jax_layer_params(rs, c):
    """fp32 parameters most of which bf16 cannot hold (scales 1 + 2^-9 + noise)."""
    scale = (1.0 + 2.0 ** -9 + 0.05 * rs.randn(c)).astype(np.float32)
    bias = (0.05 * rs.randn(c)).astype(np.float32)
    return scale, bias


@pytest.mark.parametrize("layer", ["group_norm", "layer_norm", "dense"])
def test_layers_apply_fp32_params_at_bf16_as_jax_does(layer):
    """bf16 compute, fp32 parameters, one layer on both sides. A norm
    applies its fp32 scale and bias as stored: its output equals the JAX
    module's in at least 99 % of the elements (the fp32 statistics may round
    apart), while with its parameters rounded to bf16 first it differs in
    more than 5 %. The linear layer casts its weight to bf16 at use: its
    output is the bf16-stored layer's bit for bit, within bf16 noise (1e-2
    relative RMS) of flax's ``Dense``, and not the product of the fp32
    weight."""
    import flax.linen as fnn

    from live2diff_tpu.models import layers as jlayers

    rs = np.random.RandomState({"group_norm": 0, "layer_norm": 1, "dense": 2}[layer])
    c = 32
    x = rs.randn(2, 64, c).astype(np.float32)
    scale, bias = _jax_layer_params(rs, c)
    if layer == "dense":
        kernel = (rs.randn(c, c) / np.sqrt(c) * (1 + 2.0 ** -9)).astype(np.float32)
        jmod = fnn.Dense(c, dtype=jnp.bfloat16, param_dtype=jnp.float32)
        jparams = {"params": {"kernel": kernel, "bias": bias}}
        tmod = layers.Linear(c, c)
        tparams = {"weight": kernel.T, "bias": bias}
    else:
        if layer == "group_norm":
            jmod = jlayers.FusedGroupNorm(num_groups=4, act="silu", dtype=jnp.bfloat16,
                                          param_dtype=jnp.float32)
            tmod = layers.FusedGroupNorm(4, c, 1e-5, act="silu")
        else:
            jmod = jlayers.FusedLayerNorm(dtype=jnp.bfloat16, param_dtype=jnp.float32)
            tmod = layers.FusedLayerNorm(c)
        jparams = {"params": {"scale": scale, "bias": bias}}
        tparams = {"weight": scale, "bias": bias}
    ref = _f32(jmod.apply(jparams, jnp.asarray(x, jnp.bfloat16)))
    xb = torch.from_numpy(x).bfloat16()
    outs = {}
    for stored in (torch.float32, torch.bfloat16):
        tmod.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)).to(stored)
                              for k, v in tparams.items()})
        tmod.float() if stored == torch.float32 else tmod.bfloat16()
        with torch.no_grad():
            out = tmod(xb)
        assert out.dtype == torch.bfloat16
        outs[stored] = _f32(out)
    if layer == "dense":
        # cast at use is rounding first: the bf16-stored layer's output bit for
        # bit; XLA's and torch's bf16 products round apart (bf16 noise), and
        # products of the fp32 weight (no cast) differ in many elements
        uncast = _f32(torch.nn.functional.linear(
            xb.float(), torch.from_numpy(kernel.T.copy()), torch.from_numpy(bias)).bfloat16())
        assert np.array_equal(outs[torch.float32], outs[torch.bfloat16])
        assert rel_rms(outs[torch.float32], ref) < 1e-2
        assert np.mean(outs[torch.float32] != uncast) > 0.05
        return
    assert np.mean(outs[torch.float32] == ref) > 0.99
    assert np.mean(outs[torch.bfloat16] != ref) > 0.05


def test_linear_casts_its_parameters_to_the_input_dtype():
    """``layers.Linear`` with fp32 parameters and a bf16 input is the bf16
    linear of the rounded parameters; with matching dtypes it is
    ``nn.Linear``."""
    torch.manual_seed(0)
    lin = layers.Linear(8, 4)
    x = torch.randn(3, 8)
    assert torch.equal(lin(x), torch.nn.functional.linear(x, lin.weight, lin.bias))
    xb = x.bfloat16()
    want = torch.nn.functional.linear(xb, lin.weight.bfloat16(), lin.bias.bfloat16())
    assert lin(xb).dtype == torch.bfloat16 and torch.equal(lin(xb), want)
    assert layers.at_dtype(lin.weight, torch.float32) is lin.weight
