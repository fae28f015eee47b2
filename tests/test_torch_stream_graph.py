"""The stream step's in-place state, ``set_prompt`` and ``stream_burst``.

On CUDA the port replays a CUDA graph of the step (``stream/graph.py``),
which needs the step to write its whole state in place and ``set_prompt``
to write into its buffer. These tests hold those properties on the CPU,
where the same step body runs eagerly, and hold ``stream_burst`` to N
``__call__``s (bit for bit) and to the JAX package's ``stream_burst`` (a
``lax.scan`` of the step) with the JAX draws replayed, at
``tests/test_torch_pipeline.py``'s tiny configuration and tolerance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import PROMPT_LEN, TINY_H, TINY_W, jax_taesd, jax_unet, port_taesd, port_unet
from _torch_parity import rel_err, to_np
from live2diff_tpu.schedule import LCMSchedule as JaxLCMSchedule
from live2diff_tpu.stream.pipeline import StreamConfig as JaxStreamConfig
from live2diff_tpu.stream.pipeline import StreamDiffusionDepth as JaxStream
from live2diff_tpu_torch.schedule import LCMSchedule
from live2diff_tpu_torch.stream.graph import state_tensors
from live2diff_tpu_torch.stream.pipeline import StreamConfig, StreamDiffusionDepth

WARM, STEPS, SEED = 8, 2, 5
LH, LW = TINY_H // 8, TINY_W // 8
BURST = 6
# as tests/test_torch_pipeline.py: the same fp32 math in another order,
# carried from frame to frame by the cache and latent buffers
FP32_TOL = 1e-3


@pytest.fixture(scope="module")
def weights():
    unet, unet_params = jax_unet(seed=0)
    vae, vae_params = jax_taesd(seed=1)
    return unet, unet_params, vae, vae_params


def _port(weights, cache=torch.float32, output_uint8=False):
    _, unet_params, _, vae_params = weights
    return StreamDiffusionDepth(
        port_unet(unet_params), port_taesd(vae_params),
        LCMSchedule.create(50, t_index_list=[30, 40]),
        StreamConfig(height=TINY_H, width=TINY_W, vae_scaling=1.0, cache_dtype=cache,
                     output_uint8=output_uint8),
        device="cpu", dtype=torch.float32,
    )


def _inputs(n_frames: int, uint8: bool = False):
    rs = np.random.RandomState(31)
    warm = rs.rand(WARM, TINY_H, TINY_W, 3).astype(np.float32) * 2 - 1
    prompt = rs.randn(1, PROMPT_LEN, 12).astype(np.float32)
    frames = rs.rand(n_frames, TINY_H, TINY_W, 3)
    frames = (frames * 255).astype(np.uint8) if uint8 else (frames * 2 - 1).astype(np.float32)
    return torch.from_numpy(warm), torch.from_numpy(prompt), frames


def _assert_same_state(a, b):
    assert a.frame_idx == b.frame_idx
    for x, y in zip(state_tensors(a), state_tensors(b)):
        assert torch.equal(x, y)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("cache", [torch.float32, torch.int8])
def test_stream_burst_equals_calls(weights, cache):
    """stream_burst of N frames: the outputs and the state of N __call__s,
    bit for bit (the generator draws the same noise either way)."""
    pipe = _port(weights, cache, output_uint8=True)
    warm, prompt, frames = _inputs(BURST, uint8=True)
    state_calls, _ = pipe.prepare(warm, prompt, seed=SEED)
    state_burst, _ = pipe.prepare(warm, prompt, seed=SEED)
    outs = []
    for f in frames:
        state_calls, out = pipe(state_calls, f)
        outs.append(out)
    state_burst, burst = pipe.stream_burst(state_burst, frames)
    assert burst.shape == (BURST, TINY_H, TINY_W, 3) and burst.dtype == torch.uint8
    assert torch.equal(burst, torch.stack(outs))
    _assert_same_state(state_burst, state_calls)


def test_stream_burst_matches_jax_stream_burst(weights):
    """The port's stream_burst against the JAX package's (one lax.scan),
    with the JAX draws of every frame replayed into the port."""
    unet, unet_params, vae, vae_params = weights
    jpipe = JaxStream(
        unet, unet_params, JaxLCMSchedule.create(50, t_index_list=[30, 40]),
        JaxStreamConfig(height=TINY_H, width=TINY_W, vae_scaling=1.0, cache_dtype=jnp.float32),
        lambda p, x: vae.apply(p, x, method=vae.encode),
        lambda p, z: vae.apply(p, z, method=vae.decode),
        vae_params=vae_params,
    )
    pipe = _port(weights)
    warm, prompt, frames = _inputs(BURST)
    jstate, _ = jpipe.prepare(warm.numpy(), jnp.asarray(prompt.numpy()), seed=SEED)
    draws = []  # what the JAX warmup draws, then each frame's
    rng, r = jax.random.split(jax.random.PRNGKey(SEED))
    draws.append(np.asarray(jax.random.normal(r, (WARM, LH, LW, 4))))
    for _ in range(STEPS - 1):
        rng, r = jax.random.split(rng)
        draws.append(np.asarray(jax.random.normal(r, (WARM, LH, LW, 4))))
    rng = jstate.rng
    for _ in range(BURST):
        rng, r_enc, r_buf = jax.random.split(rng, 3)
        draws.append(np.asarray(jax.random.normal(r_enc, (1, LH, LW, 4))))
        draws.append(np.asarray(jax.random.normal(r_buf, (STEPS - 1, LH, LW, 4))))

    def replay(shape):
        arr = draws.pop(0)
        assert tuple(arr.shape) == tuple(shape), (arr.shape, shape)
        return torch.from_numpy(np.array(arr))

    state, _ = pipe.prepare(warm, prompt, seed=SEED, noise=replay)
    jstate, jouts = jpipe.stream_burst(jstate, frames)
    state, outs = pipe.stream_burst(state, frames, noise=replay)
    assert not draws
    jouts = np.asarray(jouts)
    assert outs.shape == jouts.shape
    for i in range(BURST):
        assert rel_err(to_np(outs[i]), jouts[i]) < FP32_TOL, f"frame {i}"
    assert rel_err(to_np(state.x_t_buffer), np.asarray(jstate.x_t_buffer)) < FP32_TOL
    np.testing.assert_array_equal(to_np(state.update_idx), np.asarray(jstate.update_idx))
    np.testing.assert_array_equal(to_np(state.pe_idx), np.asarray(jstate.pe_idx))
    assert state.frame_idx == int(jstate.frame_idx) == BURST


@pytest.mark.parametrize("cache", [torch.float32, torch.int8])
def test_step_writes_the_state_in_place(weights, cache):
    """Through window fill and eviction (20 frames, window 16, sink 8), each
    step returns a state holding the very tensors it was given: what a
    captured step relies on."""
    pipe = _port(weights, cache)
    warm, prompt, frames = _inputs(20)
    state, _ = pipe.prepare(warm, prompt, seed=SEED)
    tensors = state_tensors(state)
    pointers = [t.data_ptr() for t in tensors]
    for i, f in enumerate(frames):
        state, _ = pipe(state, f)
        assert state.frame_idx == i + 1
        assert all(a is b for a, b in zip(state_tensors(state), tensors))
        assert [t.data_ptr() for t in state_tensors(state)] == pointers
    assert state.attn_mask.all()  # the window filled, then evicted
    state, _ = pipe.stream_burst(state, frames[:2])
    assert [t.data_ptr() for t in state_tensors(state)] == pointers


def test_set_prompt_after_the_first_frame_writes_the_buffer(weights):
    """set_prompt after a frame keeps the prompt buffer and changes the next
    output exactly as a stream whose prompt was the new one would."""
    pipe = _port(weights)
    warm, prompt, frames = _inputs(2)
    new_prompt = torch.from_numpy(
        np.random.RandomState(5).randn(PROMPT_LEN, 12).astype(np.float32))
    states = []
    for _ in range(3):  # three equal states, each one frame in
        state, _ = pipe.prepare(warm, prompt, seed=SEED)
        states.append(pipe(state, frames[0])[0])
    buffer = pipe._prompt_embeds
    pointer = buffer.data_ptr()
    pipe.set_prompt(new_prompt)
    assert pipe._prompt_embeds is buffer and buffer.data_ptr() == pointer
    _, out = pipe(states[0], frames[1])
    with_new, with_old = _port(weights), _port(weights)
    with_new.set_prompt(new_prompt)
    with_old.set_prompt(prompt)
    assert torch.equal(out, with_new(states[1], frames[1])[1])
    assert not torch.equal(out, with_old(states[2], frames[1])[1])


def test_set_prompt_refuses_another_shape(weights):
    pipe = _port(weights)
    warm, prompt, _ = _inputs(0)
    pipe.set_prompt(prompt)
    with pytest.raises(ValueError, match="prompt buffer"):
        pipe.set_prompt(torch.zeros(1, PROMPT_LEN + 1, 12))


def test_stream_burst_raises_before_prepare(weights):
    pipe = _port(weights)
    _, _, frames = _inputs(2)
    with pytest.raises(RuntimeError, match="prepare"):
        pipe.stream_burst(pipe.init_state(), frames)
