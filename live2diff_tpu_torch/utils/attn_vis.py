"""Attention-map and window-state figures, for debugging a stream.

Port of ``live2diff_tpu/utils/attn_vis.py``: ``visualize_attn_map`` renders
one attention matrix; ``window_state_figure`` the window's visibility mask,
PE indices and next write slot per denoising step; ``cache_slot_energy``
and ``cache_energy_figure`` the RMS of each cached K slot of every motion
module. All of them read a ``StreamState`` (``stream/state.py``) and leave
the step alone. matplotlib is imported inside the figure functions only.

The caches are ``[steps, 2, window, C, HW]`` (float) or, int8, ``(data,
scales [steps, 2, window, C])``. ``cache_slot_energy`` dequantises an int8
cache (``data * scales``) before it takes the RMS; the JAX function takes
the RMS of the raw int8 codes, so for the int8 cache every written slot
shows about the same energy, whatever K held.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def visualize_attn_map(attn_map, save_path: str) -> None:
    """Render one attention matrix with a grid and a colorbar."""
    from matplotlib import pyplot as plt

    attn_map = _numpy(attn_map).astype(np.float32)
    plt.figure()
    plt.imshow(attn_map)
    ax = plt.gca()
    ax.set_xticks(np.arange(-0.5, attn_map.shape[0] - 1, 1))
    ax.set_yticks(np.arange(-0.5, attn_map.shape[1] - 1, 1))
    ax.set_xticklabels(np.arange(0, attn_map.shape[0], 1))
    ax.set_yticklabels(np.arange(0, attn_map.shape[1], 1))
    ax.grid(color="r", linestyle="-", linewidth=1)
    plt.colorbar()
    plt.savefig(save_path)
    plt.close()
    print(f"Saved to {save_path}")


def window_state_figure(state, save_path: Optional[str] = None):
    """The window state per denoising step: visible slots, the PE index of
    each slot and the next write slot. Returns the figure."""
    from matplotlib import pyplot as plt

    mask = _numpy(state.attn_mask)
    pe = _numpy(state.pe_idx)
    upd = _numpy(state.update_idx)
    steps, window = mask.shape

    fig, axes = plt.subplots(1, 2, figsize=(2 + window * 0.45, 2 + steps * 0.5))
    axes[0].imshow(mask, cmap="Greens", vmin=0, vmax=1, aspect="auto")
    axes[0].set_title("visible slots")
    axes[1].imshow(pe, cmap="viridis", aspect="auto")
    axes[1].set_title("PE index per slot")
    for ax in axes:
        ax.set_xlabel("window slot")
        ax.set_ylabel("denoise step")
        ax.set_xticks(range(window))
        ax.set_yticks(range(steps))
    for s in range(steps):
        axes[0].plot(upd[s], s, "r*", markersize=14)
        for w in range(window):
            axes[1].text(w, s, str(pe[s, w]), ha="center", va="center", color="w", fontsize=7)
    axes[0].plot([], [], "r*", label="next write slot")
    axes[0].legend(loc="upper right", fontsize=7)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
        plt.close(fig)
        print(f"Saved to {save_path}")
    return fig


def cache_slot_energy(state) -> np.ndarray:
    """``[modules, steps, window]``: the RMS over channels and positions of
    each cache slot's K, an int8 cache dequantised first. Shows the sink
    slots persisting and the rolling slots being overwritten."""
    rows = []
    for cache in state.kv_caches:
        if isinstance(cache, tuple):
            data, scales = cache
            k = data[:, 0].float() * scales[:, 0, ..., None].float()
        else:
            k = cache[:, 0].float()  # [steps, window, C, HW]
        rows.append(_numpy(torch.sqrt((k * k).mean(dim=(-1, -2)))))
    return np.stack(rows)


def cache_energy_figure(state, save_path: Optional[str] = None):
    """Heatmap of ``cache_slot_energy`` for every motion module, one panel
    a denoising step. Returns the figure."""
    from matplotlib import pyplot as plt

    energy = cache_slot_energy(state)  # [modules, steps, window]
    n_mod, steps, window = energy.shape
    fig, axes = plt.subplots(1, steps, figsize=(3 * steps + 2, 0.25 * n_mod + 2), squeeze=False)
    for s in range(steps):
        ax = axes[0][s]
        im = ax.imshow(energy[:, s], aspect="auto", cmap="magma")
        ax.set_title(f"denoise step {s}")
        ax.set_xlabel("window slot")
        ax.set_ylabel("motion module (traversal order)")
        fig.colorbar(im, ax=ax, shrink=0.8)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
        plt.close(fig)
        print(f"Saved to {save_path}")
    return fig
