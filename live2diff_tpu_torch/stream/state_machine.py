"""Attention-window bookkeeping for the streaming KV-cache, in torch.

Port of ``live2diff_tpu/stream/state_machine.py``. Every temporal attention
layer attends over a fixed ``window_size``-slot cache per denoising step;
the first ``sink_size`` slots hold the warmup frames and are never evicted,
the rest fill left to right and are then recycled by positional index.
Three small integer tensors, shared by all attention layers, drive this:

* ``attn_mask``  [steps, window] bool — which slots are visible this frame,
* ``pe_idx``     [steps, window] int64 — positional-encoding index per slot,
* ``update_idx`` [steps] int64 — the slot each step writes its new K/V into.

The update is branchless tensor code, so it stays on the device with the
rest of the stream step and never waits on the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

WARMUP_FRAMES = 8
WINDOW_SIZE = 16


def init_window_state(
    num_steps: int,
    window_size: int = WINDOW_SIZE,
    sink_size: int = WARMUP_FRAMES,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Initial (attn_mask, pe_idx, update_idx) after warmup.

    All rows see the ``sink_size`` warmup slots; row 0 (the noisiest step,
    which processes the new frame) also sees the slot it is about to write.
    Row 1 first writes one slot further right: that slot is overwritten
    before it is ever unmasked, so no stale data reaches attention.
    """
    mask = torch.zeros((num_steps, window_size), dtype=torch.bool, device=device)
    mask[:, :sink_size] = True
    mask[0, sink_size] = True
    pe_idx = torch.arange(window_size, device=device).repeat(num_steps, 1)
    update_idx = torch.full((num_steps,), sink_size, dtype=torch.long, device=device)
    if num_steps > 1:
        update_idx[1] = sink_size + 1
    return mask, pe_idx, update_idx


def update_window_state(
    attn_mask: torch.Tensor,
    pe_idx: torch.Tensor,
    update_idx: torch.Tensor,
    sink_size: int = WARMUP_FRAMES,
    out: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Advance the window state by one frame (called after each UNet step).

    Per row: while the window still has masked slots, the next write goes to
    the first unfilled slot and PEs stay absolute; once full, the non-sink
    PEs roll by one and the slot holding the largest PE (the oldest) is
    evicted. One more slot is unmasked each frame until all are visible.
    ``update_idx`` is not read: the next slot follows from mask and PEs.

    ``out``: three tensors (the inputs themselves, for the stream step) that
    receive (mask, pe_idx, update_idx) in place, each written by the op
    that computes it, so the in-place update adds no launch.
    """
    del update_idx
    mask_out, pe_out, upd_out = out if out is not None else (None, None, None)
    window_size = attn_mask.shape[-1]
    full = attn_mask.all(dim=-1, keepdim=True)  # [steps, 1]
    filled = attn_mask.long().sum(dim=-1)  # [steps]
    rolled = torch.cat(
        [pe_idx[:, :sink_size], torch.roll(pe_idx[:, sink_size:], 1, dims=-1)], dim=-1
    )
    new_pe = torch.where(full, rolled, pe_idx, out=pe_out)
    # torch.argmax returns the first maximal index, as jnp.argmax does
    new_upd = torch.where(full[:, 0], torch.argmax(new_pe, dim=-1), filled, out=upd_out)
    num_unmask = torch.clamp(filled + 1, max=window_size)
    new_mask = torch.lt(torch.arange(window_size, device=attn_mask.device)[None],
                        num_unmask[:, None], out=mask_out)
    return new_mask, new_pe, new_upd


def mask_to_bias(attn_mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Bool visibility mask -> additive attention bias (0 / -inf)."""
    zero = torch.zeros((), dtype=dtype, device=attn_mask.device)
    neg = torch.full((), float("-inf"), dtype=dtype, device=attn_mask.device)
    return torch.where(attn_mask, zero, neg)
