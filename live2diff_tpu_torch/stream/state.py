"""StreamState: the complete per-stream runtime state, as tensors.

Port of ``live2diff_tpu/stream/state.py``. Everything the per-frame step
changes lives here. The step updates the KV caches in place and replaces
the small tensors, so a stream holds one copy of its caches.

A stacked state (``stream/multi.py``) holds S sessions in one set of
buffers: every tensor has a leading ``[S]`` axis, the generator is a tuple
of S generators (one a session) and ``frame_idx`` a tuple of S counts. A
stacked cache ``[S, steps, ...]`` is contiguous, so it is also the
``[S * steps, ...]`` step rows of one batched UNet call, without a copy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple, Union

import torch

# one float cache [steps, 2, window, C, HW], or an int8 cache as
# (data int8 [steps, 2, window, C, HW], scales f32 [steps, 2, window, C])
KVCache = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass
class StreamState:
    generator: torch.Generator  # the stream's noise source (stacked: one a session)
    # window bookkeeping (shared by all temporal attention layers)
    attn_mask: torch.Tensor  # [steps, window] bool
    pe_idx: torch.Tensor  # [steps, window] int64
    update_idx: torch.Tensor  # [steps] int64
    # per-layer temporal KV caches, forward-traversal order
    kv_caches: Tuple[KVCache, ...]
    # stream-batch latent buffers for the n-1 in-flight frames
    x_t_buffer: torch.Tensor  # [steps-1, h, w, 4] f32
    depth_buffer: torch.Tensor  # [steps-1, h, w, 4] f32
    frame_idx: int = 0


def cache_tensors(caches: Sequence[KVCache]) -> List[torch.Tensor]:
    """The tensors of a KV cache tuple, int8 caches as (data, scales)."""
    return [t for c in caches for t in (c if isinstance(c, tuple) else (c,))]


def as_sessions(state: StreamState) -> StreamState:
    """A single state as a stacked state of one session: views, so a step
    on it writes the single state's own tensors."""
    caches = tuple(tuple(t[None] for t in c) if isinstance(c, tuple) else c[None]
                   for c in state.kv_caches)
    return dataclasses.replace(
        state, generator=(state.generator,), attn_mask=state.attn_mask[None],
        pe_idx=state.pe_idx[None], update_idx=state.update_idx[None], kv_caches=caches,
        x_t_buffer=state.x_t_buffer[None], depth_buffer=state.depth_buffer[None],
        frame_idx=(state.frame_idx,))
