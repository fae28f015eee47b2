"""Multi-session serving: the port's ``MultiStream`` against the JAX one and
against single sessions, mirroring tests/test_multi_stream.py.

The JAX ``MultiStream`` (S = 2) runs once a module on the tiny pipeline of
tests/test_torch_pipeline.py (tiny UNet, TAESD hidden 8, 64x64, fp32 cache,
no depth): ``prepare`` from seeds 3 and 4, two plain rounds, then two
masked rounds with one session idle each. Its programs are built once
here, so the other checks hold the port to its own single sessions. The
port replays each session's JAX draws (read off that session's PRNG key
before the round) into its step.

Tolerances: 1e-3 relative against JAX, as tests/test_torch_pipeline.py's
fp32 stream (the same math in another order, through a recurrent stream);
against the port's own single sessions 1e-4 relative with a fp32 cache
(batched products at another batch size round differently) and 2e-2 with
an int8 cache (a K/V value within rounding of a .5 boundary may take the
next code, as in tests/test_torch_pipeline.py); an idle session's state
bit-equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import NARROW_DPT, PROMPT_LEN, TINY_H, TINY_W, jax_dpt, port_dpt, rel_err, to_np
from live2diff_tpu.stream.multi import MultiStream as JaxMultiStream
from live2diff_tpu_torch.stream.graph import state_tensors
from live2diff_tpu_torch.stream.multi import MultiStream
from test_torch_pipeline import FP32_TOL, INT8_TOL, _normal, _pipes, _Replay, weights  # noqa: F401

S, STEPS, WARM = 2, 2, 8
LH, LW = TINY_H // 8, TINY_W // 8
SEEDS = (3, 4)
BATCH_TOL = {"fp32": 1e-4, "int8": INT8_TOL}
# the JAX reference's rounds: None = every session active
ROUNDS = (None, None, (True, False), (False, True))


def _data(seed=0, rounds=len(ROUNDS)):
    rs = np.random.RandomState(seed)
    warm = (rs.rand(S, WARM, TINY_H, TINY_W, 3) * 2 - 1).astype(np.float32)
    prompts = rs.randn(S, PROMPT_LEN, 12).astype(np.float32)
    frames = (rs.rand(rounds, S, TINY_H, TINY_W, 3) * 2 - 1).astype(np.float32)
    return warm, prompts, frames


def _warmup_draws(seed):
    rng, r_enc = jax.random.split(jax.random.PRNGKey(seed))
    draws = [_normal(r_enc, (WARM, LH, LW, 4))]
    for _ in range(STEPS - 1):
        rng, r = jax.random.split(rng)
        draws.append(_normal(r, (WARM, LH, LW, 4)))
    return draws


def _step_draws(key):
    _, r_enc, r_buf = jax.random.split(key, 3)
    return [_normal(r_enc, (1, LH, LW, 4)), _normal(r_buf, (STEPS - 1, LH, LW, 4))]


@pytest.fixture(scope="module")
def pipes(weights):  # noqa: F811
    return _pipes(weights, "fp32")


@pytest.fixture(scope="module")
def jax_rounds(pipes):
    """The JAX MultiStream's warmup outputs, and each round's outputs and
    the per-session step draws it made."""
    jpipe, _ = pipes
    warm, prompts, frames = _data()
    multi = JaxMultiStream(jpipe, S)
    states, warm_out = multi.prepare(warm, jnp.asarray(prompts), seeds=list(SEEDS))
    rounds = []
    for frame, active in zip(frames, ROUNDS):
        draws = [_step_draws(states.rng[s]) for s in range(S)]
        states, out = multi(states, frame, None if active is None else np.array(active))
        rounds.append((np.asarray(out), draws))
    return np.asarray(warm_out), rounds


def test_multi_stream_matches_jax(pipes, jax_rounds):
    """prepare, two plain rounds and two masked rounds, the JAX draws
    replayed: every session's output of every round, within 1e-3."""
    _, tpipe = pipes
    jwarm, rounds = jax_rounds
    warm, prompts, frames = _data()
    multi = MultiStream(tpipe, S, prompt_len=PROMPT_LEN)
    states, twarm = multi.prepare(torch.from_numpy(warm), torch.from_numpy(prompts),
                                  seeds=SEEDS, noises=[_Replay(_warmup_draws(s)) for s in SEEDS])
    assert rel_err(to_np(twarm), jwarm) < FP32_TOL
    for r, (frame, active, (jout, draws)) in enumerate(zip(frames, ROUNDS, rounds)):
        replays = [_Replay(d) for d in draws]
        states, tout = multi(states, torch.from_numpy(frame), active, noises=replays)
        assert not any(rp.draws for rp in replays)
        assert tout.shape == (S, TINY_H, TINY_W, 3)
        for s in range(S):
            err = rel_err(to_np(tout[s]), jout[s])
            assert err < FP32_TOL, f"round {r} session {s}: {err:.2e}"
    assert states.frame_idx == (3, 3)


def _port_multi(tpipe, seed=0, rounds=3):
    warm, prompts, frames = _data(seed, rounds)
    multi = MultiStream(tpipe, S, prompt_len=PROMPT_LEN)
    states, _ = multi.prepare(torch.from_numpy(warm), torch.from_numpy(prompts), seeds=SEEDS)
    return multi, states, (warm, prompts, frames)


def _single(tpipe, warm, prompts, s):
    return tpipe.prepare(torch.from_numpy(warm[s]), torch.from_numpy(prompts[s][None]),
                         seed=SEEDS[s])[0]


@pytest.mark.parametrize("cache", ["fp32", "int8"])
def test_batched_sessions_match_individual(weights, cache):  # noqa: F811
    """Each session of a batched round equals its own single stream (the
    port's, same seed and frames), over 3 rounds."""
    _, tpipe = _pipes(weights, cache)
    multi, states, (warm, prompts, frames) = _port_multi(tpipe)
    outs = []
    for frame in frames:
        states, out = multi(states, torch.from_numpy(frame))
        outs.append(out)
    for s in range(S):
        state = _single(tpipe, warm, prompts, s)
        for t, frame in enumerate(frames):
            state, out = tpipe(state, torch.from_numpy(frame[s]))
            err = rel_err(to_np(outs[t][s]), to_np(out))
            assert err < BATCH_TOL[cache], f"session {s} round {t}: {err:.2e}"


def test_incremental_admission_matches_bulk_prepare(pipes):
    """prepare_session slot by slot, out of order, equals bulk prepare."""
    _, tpipe = pipes
    bulk, states_b, (warm, prompts, frames) = _port_multi(tpipe, seed=1, rounds=1)
    states_b, out_b = bulk(states_b, torch.from_numpy(frames[0]))
    inc = MultiStream(tpipe, S, prompt_len=PROMPT_LEN)
    states_i = None
    for slot in (1, 0):
        states_i, _ = inc.prepare_session(states_i, slot, torch.from_numpy(warm[slot]),
                                          torch.from_numpy(prompts[slot]), seed=SEEDS[slot])
    states_i, out_i = inc(states_i, torch.from_numpy(frames[0]))
    assert torch.equal(out_b, out_i)
    for a, b in zip(state_tensors(states_b), state_tensors(states_i)):
        assert torch.equal(a, b)


def test_idle_slot_state_unchanged_then_matches_a_session_that_never_idled(pipes):
    """A masked-out session comes out of the round bit-equal (every cache's
    data, the window tensors, the buffers and its generator); fed later it
    equals a single stream that never idled, the active one too."""
    _, tpipe = pipes
    multi, states, (warm, prompts, frames) = _port_multi(tpipe, seed=2)
    states, _ = multi(states, torch.from_numpy(frames[0]))
    before = [t[1].clone() for t in state_tensors(states)]
    gen_before = states.generator[1].get_state()
    active_before = [t[0].clone() for t in state_tensors(states)]
    states, out_masked = multi(states, torch.from_numpy(frames[1]), active=[True, False])
    after = state_tensors(states)
    assert all(torch.equal(b, a[1]) for b, a in zip(before, after))
    assert torch.equal(gen_before, states.generator[1].get_state())
    assert any(not torch.equal(b, a[0]) for b, a in zip(active_before, after))
    assert states.frame_idx == (2, 1)
    states, out_fed = multi(states, torch.from_numpy(frames[2]))

    for s, fed in ((0, [0, 1, 2]), (1, [0, 2])):
        state = _single(tpipe, warm, prompts, s)
        for t in fed:
            state, out = tpipe(state, torch.from_numpy(frames[t][s]))
        assert rel_err(to_np(out_fed[s]), to_np(out)) < BATCH_TOL["fp32"], s
        ours = [t[s] for t in state_tensors(states)]
        theirs = state_tensors(state)
        for a, b in zip(ours[:3], theirs[:3]):  # the window tensors
            assert torch.equal(a, b)
        for a, b in zip(ours[3:], theirs[3:]):  # caches and buffers
            assert rel_err(to_np(a), to_np(b)) < BATCH_TOL["fp32"]
    assert rel_err(to_np(out_masked[0]), to_np(out_fed[0])) > 0  # it did step


def test_masked_round_with_every_session_active_equals_the_plain_round(pipes):
    _, tpipe = pipes
    plain, states_p, (_, _, frames) = _port_multi(tpipe, seed=3, rounds=2)
    masked, states_m, _ = _port_multi(tpipe, seed=3, rounds=2)
    for frame in frames:
        states_p, out_p = plain(states_p, torch.from_numpy(frame))
        states_m, out_m = masked(states_m, torch.from_numpy(frame), active=[True, True])
        assert torch.equal(out_p, out_m)
    assert all(torch.equal(a, b) for a, b in zip(state_tensors(states_p),
                                                  state_tensors(states_m)))


def test_reseeded_slot_restarts_its_stream(pipes):
    """prepare_session on a used slot reseeds the slot's own generator in
    place: the slot then equals a fresh single stream."""
    _, tpipe = pipes
    multi, states, (warm, prompts, frames) = _port_multi(tpipe, seed=4)
    gen = states.generator[0]
    for frame in frames[:2]:
        states, _ = multi(states, torch.from_numpy(frame))
    states, _ = multi.prepare_session(states, 0, torch.from_numpy(warm[1]),
                                      torch.from_numpy(prompts[1]), seed=9)
    assert states.generator[0] is gen and states.frame_idx == (0, 2)
    states, out = multi(states, torch.from_numpy(frames[2]))
    state = tpipe.prepare(torch.from_numpy(warm[1]), torch.from_numpy(prompts[1][None]),
                          seed=9)[0]
    state, ref = tpipe(state, torch.from_numpy(frames[2][0]))
    assert rel_err(to_np(out[0]), to_np(ref)) < BATCH_TOL["fp32"]


def test_states_of_another_multi_stream_are_refused(pipes):
    _, tpipe = pipes
    a = MultiStream(tpipe, S, prompt_len=PROMPT_LEN)
    b = MultiStream(tpipe, S, prompt_len=PROMPT_LEN)
    with pytest.raises(ValueError, match="stacked state"):
        a.prepare_session(b.alloc_states(), 0, torch.zeros(WARM, TINY_H, TINY_W, 3),
                          torch.zeros(PROMPT_LEN, 12))
    with pytest.raises(RuntimeError, match="prepare"):
        a(a.init_states(), torch.zeros(S, TINY_H, TINY_W, 3))


@pytest.fixture(scope="module")
def depth():
    dpt, params = jax_dpt(NARROW_DPT)
    return dpt, params, port_dpt(params, NARROW_DPT)


def test_depth_is_normalised_per_session(weights, depth):  # noqa: F811
    """Two sessions whose frames have very different depth ranges: the
    batched depth image equals each session's own (JAX: its vmap over
    sessions), not a min-max over both."""
    jpipe, tpipe = _pipes(weights, "fp32", depth=depth)
    rs = np.random.RandomState(5)
    frames = np.stack([
        np.full((TINY_H, TINY_W, 3), -0.9, np.float32) + 0.05 * rs.rand(TINY_H, TINY_W, 3),
        (rs.rand(TINY_H, TINY_W, 3) * 2 - 1),
    ]).astype(np.float32)
    with torch.no_grad():
        ours = tpipe._depth_image(torch.from_numpy(frames), sessions=S).numpy()
        alone = np.stack([tpipe._depth_image(torch.from_numpy(f[None]))[0].numpy()
                          for f in frames])
        pooled = tpipe._depth_image(torch.from_numpy(frames)).numpy()
    ref = np.asarray(jax.jit(jax.vmap(jpipe._depth_image, in_axes=(None, 0)))(
        jpipe.params, jnp.asarray(frames[:, None])))[:, 0]
    assert rel_err(ours, alone) < BATCH_TOL["fp32"]  # the DPT at batch 2 and 1
    assert rel_err(ours, ref) < FP32_TOL
    spread = ours.max(axis=(1, 2, 3)) - ours.min(axis=(1, 2, 3))
    pooled_spread = pooled.max(axis=(1, 2, 3)) - pooled.min(axis=(1, 2, 3))
    # each session normalised over its own range; pooled, one is squeezed
    assert (spread > 0.5).all() and (pooled_spread <= spread + 1e-6).all(), (
        spread, pooled_spread)
    assert (pooled_spread < 0.6 * spread).any(), (spread, pooled_spread)
    assert rel_err(pooled, ours) > 1e-2
