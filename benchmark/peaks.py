"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit: 989 TFLOP/s in bf16, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def peaks_for(device_name: str) -> Optional[Dict[str, float]]:
    """The card's peaks, or None for a card the table does not hold (its
    shares of a peak are then left out)."""
    return PEAKS.get(device_name)
