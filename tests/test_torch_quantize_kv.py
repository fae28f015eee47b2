"""The int8 KV cache's quantisation against the JAX package, at full width.

``models/motion.py:_quantize_kv`` divides the clamped absmax by a 0-dim
127.0 made once per device (on CUDA, torch divides by a Python scalar
through its reciprocal, one ulp off the quotient the JAX package takes).
Here, on the CPU, its scales and codes are held bit for bit to
``live2diff_tpu/models/motion.py:_quantize_kv`` at the four ``[2, HW, C]``
cache writes of a 512x512 stream step; ``tests/test_torch_kernels_cuda.py``
holds the card to the CPU at the same shapes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live2diff_tpu.models.motion import _quantize_kv as jax_quantize_kv
from live2diff_tpu_torch.models.motion import _divisor_127, _quantize_kv


@pytest.mark.parametrize("c,hw", [(320, 4096), (640, 1024), (1280, 256), (1280, 64)])
def test_quantize_kv_matches_jax_at_cache_shapes(c, hw):
    rng = np.random.default_rng(c + hw)
    # per-channel spreads over three decades, so the scales take many exponents
    x = (rng.standard_normal((2, hw, c)) * 10.0 ** rng.uniform(-2, 1, (1, 1, c))).astype(np.float32)
    jq, js = jax_quantize_kv(jnp.asarray(x), (1,))
    tq, ts = _quantize_kv(torch.from_numpy(x), 1)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def test_divisor_is_made_once_per_device():
    cpu = torch.device("cpu")
    d = _divisor_127(cpu)
    assert d is _divisor_127(cpu)  # no new tensor (or copy to a card) per call
    assert d.dim() == 0 and d.dtype == torch.float32 and d.item() == 127.0
