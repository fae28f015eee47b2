"""Multi-session serving: S independent streams, one batched step a round.

Port of ``live2diff_tpu/stream/multi.py``. The per-session state is stacked
on a leading session axis (``stream/state.py``) and one step runs every
session at once: one encode of the S frames, one UNet call at batch
S * steps (the caches' ``[S, steps, ...]`` buffers viewed as step rows),
one decode. Sessions share the weights and shapes; prompts, generators and
window state are their own.

Two steps, as in the JAX package:

* the plain step, for rounds in which every session has a frame;
* the masked step (``active``): before the step it saves, for every
  session, the one cache slot per step row that the step will write
  (``update_idx``) and the small tensors (window tensors, latent buffers);
  after it, it writes them back for the idle sessions. An idle session's
  generator is put back on the host, so its state comes out of the round
  as it went in, bit for bit.

On CUDA each step is one CUDA graph over the stacked buffers, and both are
captured when the ``MultiStream`` is built, before any slot holds a
session (a server switches between them while serving): one eager warm step
of each runs first on the fresh stacked state, which is then reset. The
graphs read this ``MultiStream``'s one stacked state, its prompt buffer
and its ``active`` buffer, written before a masked replay. Every session's
generator is registered with both graphs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.timing import RECORDER, with_routes
from .graph import capture_graph, state_tensors
from .pipeline import NoiseFn, Noises, StreamDiffusionDepth
from .state import StreamState, cache_tensors
from .state_machine import init_window_state


@dataclasses.dataclass
class _SessionGraph:
    graph: "torch.cuda.CUDAGraph"
    frame: torch.Tensor  # the static [S, H, W, 3] input
    out: torch.Tensor  # the static [S, H, W, 3] output
    capture_s: float
    events: List[torch.cuda.Event]  # its stage events (``stage_marks``)


class MultiStream:
    """S concurrent streams of one ``StreamDiffusionDepth``, stepped
    together. ``prompt_len`` is the prompt embeddings' token count (77 for
    CLIP); on CUDA both steps are captured at construction for uint8 frames,
    which the server feeds (float frames are captured at their first call)."""

    def __init__(self, stream: StreamDiffusionDepth, num_sessions: int, prompt_len: int = 77):
        self.stream = stream
        self.num_sessions = s = num_sessions
        self.device = stream.device
        n = stream.num_steps
        dim = stream.unet.config.cross_attention_dim
        self._prompts = torch.zeros((s, n, prompt_len, dim), dtype=stream.dtype,
                                    device=self.device)
        self._prompts_set = False
        self._active = torch.ones(s, dtype=torch.bool, device=self.device)
        self._rows = torch.arange(s * n, device=self.device)
        self._states = self._allocate()
        self._graphs: Dict[Tuple[bool, torch.dtype], _SessionGraph] = {}
        self._pool = None
        self.owner = RECORDER.owner()  # its rounds' calls in the recorder
        self.warm_s = 0.0
        self.alloc_states()
        if self.device.type == "cuda":
            self.warm_s = self._warm(torch.uint8)
            for masked in (False, True):
                self._capture(masked, torch.uint8)
        self.alloc_states()

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def _allocate(self) -> StreamState:
        st, s = self.stream, self.num_sessions
        cfg, ucfg, n = st.cfg, st.unet.config, st.num_steps
        lh, lw = cfg.latent_height, cfg.latent_width
        caches = []
        for shape in ucfg.cache_shapes(lh, lw, n):
            if cfg.cache_dtype == torch.int8:
                caches.append((torch.empty((s, *shape), dtype=torch.int8, device=self.device),
                               torch.empty((s, *shape[:4]), device=self.device)))
            else:
                caches.append(torch.empty((s, *shape), dtype=cfg.cache_dtype,
                                          device=self.device))
        buf = (s, max(n - 1, 0), lh, lw, 4)
        return StreamState(
            generator=tuple(torch.Generator(device=self.device) for _ in range(s)),
            attn_mask=torch.empty((s, n, ucfg.window_size), dtype=torch.bool,
                                  device=self.device),
            pe_idx=torch.empty((s, n, ucfg.window_size), dtype=torch.long, device=self.device),
            update_idx=torch.empty((s, n), dtype=torch.long, device=self.device),
            kv_caches=tuple(caches),
            x_t_buffer=torch.empty(buf, device=self.device),
            depth_buffer=torch.empty(buf, device=self.device),
            frame_idx=(0,) * s,
        )

    def alloc_states(self) -> StreamState:
        """The stacked state, every slot reset in place to a stream's
        initial state (zero caches and buffers, the window state after
        warmup); fill slots with :meth:`prepare_session`. There is one
        stacked state a ``MultiStream``: the buffers its graphs read."""
        st = self._states
        ucfg = self.stream.unet.config
        window = init_window_state(self.stream.num_steps, ucfg.window_size, ucfg.sink_size,
                                   device=self.device)
        for dst, src in zip((st.attn_mask, st.pe_idx, st.update_idx), window):
            dst.copy_(src.expand_as(dst))
        for c in st.kv_caches:
            if isinstance(c, tuple):
                c[0].zero_()
                c[1].fill_(1.0)
            else:
                c.zero_()
        st.x_t_buffer.zero_()
        st.depth_buffer.zero_()
        self._states = dataclasses.replace(st, frame_idx=(0,) * self.num_sessions)
        return self._states

    def init_states(self, seeds=None) -> StreamState:
        """The reset stacked state with slot i's generator seeded by
        ``seeds[i]`` (default ``i``)."""
        states = self.alloc_states()
        for g, seed in zip(states.generator, range(self.num_sessions) if seeds is None else seeds):
            g.manual_seed(seed)
        return states

    # ------------------------------------------------------------------
    # prompts and admission
    # ------------------------------------------------------------------

    def set_prompts(self, prompt_embeds) -> None:
        """``[S, L, D]`` per-session prompt embeddings, into the buffer."""
        embeds = torch.as_tensor(prompt_embeds, device=self.device, dtype=self.stream.dtype)
        self._prompts.copy_(embeds[:, None].expand_as(self._prompts))
        self._prompts_set = True

    def set_prompt(self, index: int, prompt_embeds) -> None:
        """One session's prompt embedding (``[L, D]`` or ``[1, L, D]``)."""
        embeds = torch.as_tensor(prompt_embeds, device=self.device, dtype=self.stream.dtype)
        if embeds.dim() == 2:
            embeds = embeds[None]
        self._prompts[index].copy_(embeds.expand_as(self._prompts[index]))
        self._prompts_set = True

    def prepare(self, warmup_frames, prompt_embeds, seeds=None, sequential: bool = True,
                noises: Optional[Sequence[NoiseFn]] = None) -> Tuple[StreamState, torch.Tensor]:
        """warmup_frames: ``[S, 8, H, W, 3]``; prompt_embeds: ``[S, L, D]``.
        Warms every slot through :meth:`prepare_session` and returns the
        stacked state and the ``[S, 8, H, W, 3]`` warmup outputs. The port
        always warms one slot at a time (the JAX default, ``sequential``),
        so the peak is S states plus one."""
        del sequential
        self.set_prompts(prompt_embeds)
        seeds = range(self.num_sessions) if seeds is None else seeds
        states, outs = None, []
        for i, seed in enumerate(seeds):
            states, out = self.prepare_session(
                states, i, warmup_frames[i], prompt_embeds[i], seed=seed,
                noise=None if noises is None else noises[i])
            outs.append(out)
        return states, torch.stack(outs)

    def prepare_session(self, states: Optional[StreamState], index: int, warmup_frames,
                        prompt_embeds, seed: int = 0, noise: Optional[NoiseFn] = None
                        ) -> Tuple[StreamState, torch.Tensor]:
        """Warm one slot: the single-stream warmup on a transient state from
        ``seed``, then its tensors copied into slot ``index`` in place and
        the slot's generator set to the transient one's state. ``states``
        may be None (the stacked state is reset first)."""
        if states is None:
            states = self.alloc_states()
        self._check_own(states)
        self.set_prompt(index, prompt_embeds)
        st = self.stream.init_state(seed)
        frames = torch.as_tensor(warmup_frames, device=self.device)
        st, out = self.stream._warmup_denoise(st, frames, self._prompts[index], noise)
        with torch.no_grad():
            for dst, src in zip(state_tensors(states), state_tensors(st)):
                dst[index].copy_(src)
        states.generator[index].set_state(st.generator.get_state())
        idx = list(states.frame_idx)
        idx[index] = 0
        self._states = dataclasses.replace(states, frame_idx=tuple(idx))
        return self._states, out

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def _check_own(self, states: StreamState) -> None:
        if any(a.data_ptr() != b.data_ptr()
               for a, b in zip(state_tensors(states), state_tensors(self._states))):
            raise ValueError("states: not this MultiStream's stacked state (alloc_states, "
                             "init_states, prepare or prepare_session make it)")

    def _step(self, states: StreamState, frames: torch.Tensor, masked: bool,
              noises: Noises) -> torch.Tensor:
        """The plain or the masked batched step over ``states`` (which it
        writes in place); ``self._active`` holds the masked step's mask."""
        prompts = self._prompts.reshape(-1, *self._prompts.shape[2:])
        if not masked:
            return self.stream._session_step(states, frames, prompts, noises)
        n = self.stream.num_steps
        upd = states.update_idx.reshape(-1).clone()
        small = [(t, t.clone()) for t in (states.attn_mask, states.pe_idx, states.update_idx,
                                          states.x_t_buffer, states.depth_buffer)]
        # the one slot a step row the step writes, in every cache tensor
        caches = [t.view(-1, *t.shape[2:]) for t in cache_tensors(states.kv_caches)]
        slots = [c[self._rows, :, upd] for c in caches]
        out = self.stream._session_step(states, frames, prompts, noises)
        keep = self._active[:, None].expand(-1, n).reshape(-1)  # a session's step rows
        for c, old in zip(caches, slots):
            new = c[self._rows, :, upd]
            c[self._rows, :, upd] = torch.where(keep.view(-1, *[1] * (old.dim() - 1)), new, old)
        for t, old in small:
            torch.where(self._active.view(-1, *[1] * (t.dim() - 1)), t, old, out=t)
        return out

    def _warm(self, frame_dtype: torch.dtype) -> float:
        """One eager plain and one eager masked step on the fresh stacked
        state, on a side stream (kernel builds and loads, library plan
        choices), before any capture. Returns wall seconds."""
        t0 = time.perf_counter()
        frames = torch.zeros((self.num_sessions, self.stream.cfg.height, self.stream.cfg.width,
                              3), dtype=frame_dtype, device=self.device)
        self._active[0] = False
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for masked in (False, True):
                self._step(self._states, frames, masked, None)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        self._active.fill_(True)
        return time.perf_counter() - t0

    def _capture(self, masked: bool, frame_dtype: torch.dtype) -> _SessionGraph:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        cfg = self.stream.cfg
        frame = torch.zeros((self.num_sessions, cfg.height, cfg.width, 3), dtype=frame_dtype,
                            device=self.device)
        states = self._states
        with self.stream.stage_marks() as events:
            graph, out, seconds = capture_graph(
                lambda: self._step(states, frame, masked, None), states.generator, self._pool)
        self._graphs[masked, frame_dtype] = g = _SessionGraph(graph, frame, out, seconds, events)
        return g

    def release_graphs(self) -> None:
        """Release both captured steps and their pool now (a caller about to
        drop this ``MultiStream``); a later round captures again."""
        if self._graphs:
            torch.cuda.synchronize(self.device)
        for g in self._graphs.values():
            g.graph.reset()
        self._graphs.clear()
        self._pool = None

    def trace_summary(self) -> dict:
        """The recorder's read-out of this ``MultiStream``'s rounds
        (``utils/timing.py``: ``Recorder.summary``): per span and device
        stage count, median, p95, mean, std and EMA in ms, and the
        counters, ``norm_routes``, ``codec_routes`` and
        ``conv_weight_relayouts`` among them."""
        RECORDER.read_stages(self.owner)
        return with_routes(RECORDER.summary(self.owner))

    @property
    def capture_s(self) -> Dict[str, float]:
        """Wall seconds of each captured graph's capture."""
        return {f"{'masked' if m else 'plain'} {dt}": g.capture_s
                for (m, dt), g in self._graphs.items()}

    def __call__(self, states: StreamState, frames, active=None,
                 noises: Optional[Sequence[NoiseFn]] = None
                 ) -> Tuple[StreamState, torch.Tensor]:
        """frames: ``[S, H, W, 3]`` (uint8, or float in [-1, 1]) -> (states,
        ``[S, H, W, 3]`` outputs on the device).

        ``active``: optional ``[S]`` bools. The sessions marked False run in
        the batch (its shape is fixed) but come out of the round as they
        went in: caches, window tensors, buffers and generator.
        ``active=None`` runs the plain step. On CUDA without ``noises`` this
        replays the step's graph and returns a copy of its output; with
        ``noises`` (one noise function a session) it runs eagerly."""
        replay = self.device.type == "cuda" and noises is None
        with RECORDER.root("multi.round", self.owner):
            # the previous round's stage times, where its replay has completed
            RECORDER.read_stages(self.owner)
            return self._round(states, frames, active, noises, replay)

    def _round(self, states: StreamState, frames, active, noises: Noises, replay: bool
               ) -> Tuple[StreamState, torch.Tensor]:
        """One round, by a graph replay or eagerly (the replay's reference)."""
        if not self._prompts_set:
            raise RuntimeError("set_prompts(), prepare() or prepare_session() first")
        s = self.num_sessions
        frames = torch.as_tensor(frames)
        if tuple(frames.shape) != (s, self.stream.cfg.height, self.stream.cfg.width, 3):
            raise ValueError(f"frames of shape {tuple(frames.shape)}, expected "
                             f"[{s}, {self.stream.cfg.height}, {self.stream.cfg.width}, 3]")
        masked = active is not None
        act = np.ones(s, bool) if active is None else np.asarray(active, dtype=bool)
        if masked:  # from pinned memory: no host sync with the card
            act_t = torch.from_numpy(act)
            self._active.copy_(act_t.pin_memory() if self.device.type == "cuda" else act_t,
                               non_blocking=True)
        # an idle session's generator is put back after the round, on the host
        idle = [states.generator[i] for i in range(s) if not act[i]]
        saved = [g.get_state() for g in idle]
        if replay:
            self._check_own(states)
            g = (self._graphs.get((masked, frames.dtype))
                 or self._capture(masked, frames.dtype))
            with RECORDER.span("multi.upload"):
                g.frame.copy_(frames, non_blocking=True)
            with RECORDER.span("multi.replay"):
                g.graph.replay()
            RECORDER.stages_pending(g.events)
            with RECORDER.span("multi.clone"):
                out = g.out.clone()
        else:
            out = self._step(states, frames.to(self.device), masked, noises)
        for gen, st in zip(idle, saved):
            gen.set_state(st)
        idx = tuple(i + int(a) for i, a in zip(states.frame_idx, act))
        self._states = dataclasses.replace(states, frame_idx=idx)
        return self._states, out
