"""The captured frame step: one CUDA graph replay a frame.

Port of the JAX package's one-program-per-frame design
(``live2diff_tpu/stream/pipeline.py:146``, ``jax.jit(self._frame_step,
donate_argnums=(1,))``). On CUDA, ``StreamDiffusionDepth.__call__`` and
``stream_burst`` replay a ``torch.cuda.CUDAGraph`` of ``_frame_step``: every
kernel of the step in one launch. A graph reads and writes only static
buffers:

* the state's own tensors (window tensors, every KV cache, the latent
  buffers), which the step writes in place, so a state's tensors never move;
* the stream's prompt buffer, which ``set_prompt`` writes in place;
* one frame-input buffer of its own, which each call fills by a device copy;
* its output buffer, which the next replay overwrites: callers copy it out.

The state's ``torch.Generator`` is registered with the graph, so a replay
draws from it and advances it as the eager step does: the same seed gives
the same numbers either way.

A graph is captured at the first call on a state and frame dtype, after the
eager warm step (``StreamDiffusionDepth.warm_frame_step``) has run once for
that dtype, and is found again by the data pointers of every state tensor
it reads. The graphs of one stream share one memory pool. They hold a
state's tensors only by weak reference: a state the caller drops frees its
caches at once, and its graph (with its activations in the pool) is
released at the next ``prepare()`` or capture.

The kernels' wrappers count launches in Python (``ops/_build.py``
``launch_counts``, the route counts): they count one step at capture and
nothing at replay.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Callable, List, Optional, Sequence, Set, Tuple

import torch

from .state import StreamState, cache_tensors


def state_tensors(state: StreamState) -> List[torch.Tensor]:
    """Every tensor of ``state`` that the step reads and writes."""
    return [state.attn_mask, state.pe_idx, state.update_idx, *cache_tensors(state.kv_caches),
            state.x_t_buffer, state.depth_buffer]


def capture_graph(fn: Callable[[], torch.Tensor], generators: Sequence[torch.Generator],
                  pool) -> Tuple["torch.cuda.CUDAGraph", torch.Tensor, float]:
    """Capture ``fn()`` (which must read and write only static buffers) in
    a CUDA graph that draws from ``generators``: (graph, the output ``fn``
    returned, which each replay overwrites, wall seconds). A capture records
    the kernels and runs none. Raises if capture fails."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    t0 = time.perf_counter()
    # The flash, conv and stream-attention wrappers encode their TMA
    # tensor maps on the host at each launch and pass them as kernel
    # parameters: the graph keeps the maps made here, which name the
    # static buffers, so they stay right at every replay and nothing is
    # encoded again. thread_local: an uploader thread (PipelinedStream)
    # may copy on its own stream during a capture.
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        out = fn()
    return graph, out, time.perf_counter() - t0


@dataclasses.dataclass
class CapturedStep:
    graph: "torch.cuda.CUDAGraph"
    generator: torch.Generator
    pointers: Tuple[int, ...]  # data_ptr of each of state_tensors(state)
    refs: List[weakref.ref]  # the same tensors, held weakly
    frame: torch.Tensor  # the static frame input
    out: torch.Tensor  # the static output, overwritten by each replay
    capture_s: float  # wall seconds of the capture

    def alive(self) -> bool:
        return all(r() is not None for r in self.refs)

    def reads(self, state: StreamState, frame_dtype: torch.dtype) -> bool:
        return (self.frame.dtype == frame_dtype and self.generator is state.generator
                and self.pointers == tuple(t.data_ptr() for t in state_tensors(state))
                and self.alive())


class StepGraphs:
    """The captured steps of one ``StreamDiffusionDepth``, one a state and
    frame dtype, sharing one memory pool."""

    def __init__(self):
        self.graphs: List[CapturedStep] = []
        self.warmed: Set[torch.dtype] = set()  # frame dtypes warm_frame_step has run
        self._pool = None

    def step(self, pipe, state: StreamState, frame: torch.Tensor
             ) -> Tuple[StreamState, torch.Tensor]:
        """Replay the step of ``pipe`` on ``state`` for ``frame`` (host or
        device), capturing it first if no graph reads this state. Returns the
        advanced state and the graph's output buffer. No host sync."""
        g = self.find(state, frame.dtype) or self.capture(pipe, state, frame.dtype)
        if frame.shape != g.frame.shape:
            raise ValueError(f"frame of shape {tuple(frame.shape)}, expected "
                             f"{tuple(g.frame.shape)}")
        g.frame.copy_(frame, non_blocking=True)
        g.graph.replay()
        return dataclasses.replace(state, frame_idx=state.frame_idx + 1), g.out

    def find(self, state: StreamState, frame_dtype: torch.dtype) -> Optional[CapturedStep]:
        return next((g for g in self.graphs if g.reads(state, frame_dtype)), None)

    def capture(self, pipe, state: StreamState, frame_dtype: torch.dtype) -> CapturedStep:
        """Capture ``pipe._frame_step`` on ``state``. Raises if capture fails:
        the step never falls back to eager."""
        if frame_dtype not in self.warmed:
            pipe.warm_frame_step(frame_dtype)
        self.release_dropped()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        cfg = pipe.cfg
        frame = torch.zeros((cfg.height, cfg.width, 3), dtype=frame_dtype, device=pipe.device)
        tensors = state_tensors(state)
        graph, out, seconds = capture_graph(
            lambda: pipe._frame_step(state, frame, pipe._prompt_embeds)[1],
            (state.generator,), self._pool)
        captured = CapturedStep(
            graph=graph, generator=state.generator,
            pointers=tuple(t.data_ptr() for t in tensors),
            refs=[weakref.ref(t) for t in tensors], frame=frame, out=out, capture_s=seconds)
        self.graphs.append(captured)
        return captured

    def release_all(self) -> None:
        """Release every graph now, and with them their pool (a pipeline
        about to be dropped). Syncs the device first."""
        if self.graphs:
            torch.cuda.synchronize()
        for g in self.graphs:
            g.graph.reset()
        self.graphs = []
        self._pool = None

    def release_dropped(self) -> None:
        """Release the graphs of states the caller has dropped. Syncs the
        device first, since a released graph may still be replaying."""
        dropped = [g for g in self.graphs if not g.alive()]
        if not dropped:
            return
        torch.cuda.synchronize()
        self.graphs = [g for g in self.graphs if g.alive()]
        for g in dropped:
            g.graph.reset()
