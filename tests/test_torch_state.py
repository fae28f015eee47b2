"""The port's window state machine against the JAX one: exact integer equality."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from live2diff_tpu.stream import state_machine as jsm
from live2diff_tpu_torch.stream import state_machine as tsm


@pytest.mark.parametrize("num_steps", [1, 2, 3, 4])
def test_window_state_matches_jax_for_40_frames(num_steps):
    jstate = jsm.init_window_state(num_steps)
    tstate = tsm.init_window_state(num_steps)
    for frame in range(41):
        for name, j, t in zip(("attn_mask", "pe_idx", "update_idx"), jstate, tstate):
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(j), err_msg=f"{name} at frame {frame}"
            )
        jstate = jsm.update_window_state(*jstate)
        tstate = tsm.update_window_state(*tstate)


def test_stale_slot_is_written_before_it_is_visible():
    """Row 1 first writes slot sink+1 while it is masked; every non-sink
    slot that attention sees has been written by the stream by then."""
    num_steps = 2
    mask, pe, upd = tsm.init_window_state(num_steps)
    assert upd.tolist() == [tsm.WARMUP_FRAMES, tsm.WARMUP_FRAMES + 1]
    written = np.zeros((num_steps, tsm.WINDOW_SIZE), dtype=bool)
    written[:, : tsm.WARMUP_FRAMES] = True  # warmup frames fill the sink
    for _ in range(40):
        written[np.arange(num_steps), upd.numpy()] = True  # this frame's K/V write
        visible = mask.numpy()
        assert written[visible].all(), (visible, written)
        mask, pe, upd = tsm.update_window_state(mask, pe, upd)
    # once full, the PEs stay a permutation and the sink is never evicted
    assert mask.all()
    for row in pe.numpy():
        assert sorted(row.tolist()) == list(range(tsm.WINDOW_SIZE))
    assert (upd >= tsm.WARMUP_FRAMES).all()


def test_mask_to_bias_matches_jax():
    jmask = jsm.init_window_state(2)[0]
    tmask = tsm.init_window_state(2)[0]
    np.testing.assert_array_equal(
        tsm.mask_to_bias(tmask).numpy(), np.asarray(jsm.mask_to_bias(jmask))
    )
    assert tsm.mask_to_bias(tmask, torch.bfloat16).dtype == torch.bfloat16
