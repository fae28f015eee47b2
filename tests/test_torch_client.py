"""The port's PipelinedStream: the JAX client's contracts, and the tiny CPU
pipeline through ``map`` equal to the synchronous loop.

The contracts are those of ``tests/test_stream_client.py``: frames are
dispatched in input order whatever order their uploads finish in, nothing
is dropped, the state is threaded in order, an upload failure reaches the
caller, and no uploader thread outlives the generator. The transport is
faked by replacing the client's ``_transfer`` and ``_wait`` hooks, as those
tests fake ``jax.device_put``; the pipeline test is
``tests/test_pipeline.py::test_pipelined_client_matches_sync``'s.
"""

from __future__ import annotations

import random
import threading
import time

import numpy as np
import pytest
import torch

from live2diff_tpu_torch.builder import build_pipeline
from live2diff_tpu_torch.stream.client import PipelinedStream

H = W = 64


class _FakeStream:
    def __call__(self, state, frame):
        return state + 1, frame * 2


def _jittered(x):
    time.sleep(random.uniform(0.0, 0.003))  # a "transfer" that takes a while
    return x, None


def _client(stream, state, transfer=_jittered, **kw):
    ps = PipelinedStream(stream, state, **kw)
    ps._transfer = transfer
    ps._wait = lambda event: None
    return ps


def _run(upload_threads: int, max_in_flight: int, n: int = 120, upload_batch: int = 1):
    ps = _client(_FakeStream(), 0, max_in_flight=max_in_flight,
                 upload_threads=upload_threads, upload_batch=upload_batch)
    frames = [np.full((3,), i) for i in range(n)]
    outs = list(ps.map(frames))
    assert len(outs) == n
    assert [int(o[0]) for o in outs] == [2 * i for i in range(n)]
    assert ps.state == n


def test_single_uploader_ordered():
    _run(upload_threads=1, max_in_flight=2)


def test_parallel_uploaders_preserve_order():
    random.seed(0)
    _run(upload_threads=4, max_in_flight=3)


def test_parallel_uploaders_small_stream():
    random.seed(1)
    _run(upload_threads=3, max_in_flight=2, n=2)


def test_empty_stream():
    ps = _client(_FakeStream(), 0, upload_threads=3)
    assert list(ps.map([])) == []


def _no_leaked_threads(before, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if not set(threading.enumerate()) - before:
            return True
        time.sleep(0.01)
    return False


@pytest.mark.parametrize("upload_threads", [1, 3])
def test_upload_failure_joins_threads(upload_threads):
    """A failed upload raises to the consumer and tears down the feeder and
    uploader threads."""

    def fail(x):
        if int(x[0]) == 5:
            raise RuntimeError("transport down")
        return x, None

    before = set(threading.enumerate())
    ps = _client(_FakeStream(), 0, transfer=fail, max_in_flight=2,
                 upload_threads=upload_threads)
    with pytest.raises(RuntimeError, match="transport down"):
        list(ps.map([np.full((3,), i) for i in range(200)]))
    assert _no_leaked_threads(before), "feeder/uploader threads leaked"


@pytest.mark.parametrize("upload_threads", [1, 3])
def test_abandoned_generator_joins_threads(upload_threads):
    """Dropping the generator early (GeneratorExit) leaks no thread."""
    before = set(threading.enumerate())
    ps = _client(_FakeStream(), 0, max_in_flight=2, upload_threads=upload_threads)
    gen = ps.map([np.full((3,), i) for i in range(200)])
    for _ in range(4):
        next(gen)
    gen.close()
    assert _no_leaked_threads(before), "threads leaked after generator close"


@pytest.mark.parametrize("upload_threads", [1, 2])
def test_batched_upload_ordered(upload_threads):
    for n in (0, 1, 2, 7, 12):
        _run(upload_threads=upload_threads, max_in_flight=2, n=n, upload_batch=3)


def test_submit_and_drain_keep_order():
    ps = _client(_FakeStream(), 0, max_in_flight=2)
    ready = [ps.submit(np.full((3,), i)) for i in range(5)]
    outs = [r for r in ready if r is not None] + list(ps.drain())
    assert [int(o[0]) for o in outs] == [0, 2, 4, 6, 8]
    assert ps.state == 5 and len(ps.frame_times) == 4 and ps.throughput_fps() > 0


@pytest.fixture(scope="module")
def tiny():
    cfg = {"num_inference_steps": 50, "t_index_list": [30, 40]}
    unet = dict(block_out_channels=(8, 16, 16, 16), attention_head_dim=2,
                cross_attention_dim=12, norm_num_groups=4, motion_num_attention_heads=2)
    return build_pipeline(cfg, H, W, dtype=torch.float32, kv_cache_dtype="int8", seed=0,
                          device="cpu", unet_overrides=unet, use_depth=False).stream


@pytest.mark.parametrize("uint8", [False, True])
def test_pipelined_client_matches_sync(tiny, uint8):
    """PipelinedStream.map gives the synchronous loop's outputs, in order,
    for float32 and uint8 frames."""
    rs = np.random.RandomState(7)
    prompt = torch.from_numpy(rs.randn(1, 7, 12).astype(np.float32))
    warm = torch.from_numpy(rs.rand(8, H, W, 3).astype(np.float32) * 2 - 1)
    frames = rs.rand(6, H, W, 3)
    frames = [(f * 255).astype(np.uint8) if uint8 else (f * 2 - 1).astype(np.float32)
              for f in frames]
    state, _ = tiny.prepare(warm, prompt, seed=3)
    sync = []
    for f in frames:
        state, out = tiny(state, f)
        sync.append(out)
    state2, _ = tiny.prepare(warm, prompt, seed=3)
    ps = PipelinedStream(tiny, state2, max_in_flight=2)
    piped = list(ps.map(iter(frames)))
    assert len(piped) == len(sync)
    for a, b in zip(sync, piped):
        assert torch.equal(a, b)
    assert ps.state.frame_idx == state.frame_idx == len(frames)


@pytest.mark.parametrize("upload_batch", [1, 2])
def test_pipelined_client_drives_a_multistream(tiny, upload_batch):
    """PipelinedStream over a MultiStream of 2 sessions takes ``[S, H, W,
    3]`` uint8 rounds (one or two a copy) and gives the direct rounds'
    outputs, in order, bit for bit, with the stacked state advanced."""
    from live2diff_tpu_torch.stream.multi import MultiStream

    s = 2
    rs = np.random.RandomState(11)
    prompts = torch.from_numpy(rs.randn(s, 7, 12).astype(np.float32))
    warm = torch.from_numpy(rs.rand(s, 8, H, W, 3).astype(np.float32) * 2 - 1)
    rounds = [(rs.rand(s, H, W, 3) * 255).astype(np.uint8) for _ in range(5)]
    multi = MultiStream(tiny, s, prompt_len=7)
    states, _ = multi.prepare(warm, prompts, seeds=[3, 4])
    direct = []
    for r in rounds:
        states, out = multi(states, r)
        direct.append(out)
    states, _ = multi.prepare(warm, prompts, seeds=[3, 4])
    ps = PipelinedStream(multi, states, max_in_flight=2, upload_batch=upload_batch)
    piped = list(ps.map(iter(rounds)))
    assert len(piped) == len(direct)
    for a, b in zip(direct, piped):
        assert a.shape == (s, H, W, 3) and torch.equal(a, b)
    assert ps.state.frame_idx == (len(rounds),) * s
