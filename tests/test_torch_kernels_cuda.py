"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA Hopper GPU and ``nvcc``; without a CUDA device each
test skips. They complement ``chip_smoke.py`` (which checks the production
shapes of the 512x512 stream step) with ragged shapes: lengths that are not
multiples of the kernels' tiles, every head width the flash kernel takes,
channel counts that take the conv kernel's scalar load path, and the
wrappers' refusals. Run them on the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX, which this file does not
use.) Tolerances are relative to the plain version's largest value: the
kernels round the same bf16 operands at other points (probabilities, the
dequantised cache) and sum in another order, ~2^-8 relative at worst.
"""

from __future__ import annotations

import pytest
import torch

from live2diff_tpu_torch.ops import _build
from live2diff_tpu_torch.ops.attention import dot_product_attention, stream_window_attention
from live2diff_tpu_torch.ops.conv import conv3x3, conv3x3_plain
from live2diff_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from live2diff_tpu_torch.ops.stream_attention import (
    stream_window_attention_int8, stream_window_attention_plain,
)

pytestmark = pytest.mark.cuda

ATTN_TOL = 2e-2
CONV_TOL = 1e-2


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False  # full-fp32 plain references
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(out, ref) -> float:
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _randn(gen, dev, *shape):
    return torch.randn(*shape, generator=gen, device=dev)


@pytest.mark.parametrize("b,sq,sk,h,d", [
    (1, 100, 77, 3, 40),   # ragged query tile, cross-attention length
    (2, 64, 64, 2, 8),     # smallest head width (padded to 16)
    (1, 65, 130, 2, 80),   # one row past a tile, ragged key tiles
    (3, 8, 8, 8, 160),     # warmup motion attention: S = 8
    (1, 1, 5, 1, 24),
    (2, 200, 200, 4, 64),
    (1, 33, 129, 2, 96),
    (1, 50, 50, 1, 128),
])
def test_flash_attention_matches_plain(dev, b, sq, sk, h, d):
    gen = torch.Generator(device=dev).manual_seed(sq * 1000 + d)
    q = _randn(gen, dev, b, sq, h, d).to(torch.bfloat16)
    k = _randn(gen, dev, b, sk, h, d).to(torch.bfloat16)
    v = _randn(gen, dev, b, sk, h, d).to(torch.bfloat16)
    before = _build.launch_counts["flash_attention"]
    out = flash_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention"] == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert _rel(out, flash_attention_plain(q, k, v, d ** -0.5)) < ATTN_TOL


@pytest.mark.parametrize("b,h,w,cin,stride,bias,skip,relu", [
    (1, 37, 45, 3, 1, True, False, True),     # RGB input, ragged tiles
    (2, 20, 70, 64, 1, True, True, True),
    (1, 9, 33, 16, 1, False, False, False),
    (1, 11, 13, 5, 1, True, True, False),     # scalar load path (Cin % 8 != 0)
    (1, 16, 24, 40, 1, True, False, True),    # Cin padded to 48
    (1, 38, 46, 64, 2, False, False, False),  # encoder downsample, ragged
    (2, 64, 96, 8, 2, True, True, True),
])
def test_conv3x3_matches_plain(dev, b, h, w, cin, stride, bias, skip, relu):
    gen = torch.Generator(device=dev).manual_seed(h * 100 + cin)
    x = _randn(gen, dev, b, h, w, cin).to(torch.bfloat16)
    wt = (_randn(gen, dev, 64, cin, 3, 3) / (9 * cin) ** 0.5).to(torch.bfloat16)
    bs = _randn(gen, dev, 64).to(torch.bfloat16) if bias else None
    sk = _randn(gen, dev, b, h // stride, w // stride, 64).to(torch.bfloat16) if skip else None
    name = "conv3x3" if stride == 1 else "conv3x3_s2"
    before = _build.launch_counts[name]
    out = conv3x3(x, wt, bs, sk, relu, stride)
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 1
    ref = conv3x3_plain(x, wt, bs, sk, relu, stride)
    assert out.shape == ref.shape == (b, h // stride, w // stride, 64)
    assert _rel(out, ref) < CONV_TOL


@pytest.mark.parametrize("s,hw,c,heads", [
    (2, 100, 320, 8),   # ragged position tile
    (1, 33, 64, 2),
    (2, 64, 1280, 8),   # the 8x8 latent level (HW = 64)
    (3, 7, 16, 1),
])
def test_stream_attention_int8_matches_plain(dev, s, hw, c, heads):
    gen = torch.Generator(device=dev).manual_seed(hw * 10 + c)
    q = _randn(gen, dev, s, hw, c).to(torch.bfloat16)
    data = torch.randint(-127, 128, (s, 2, 16, c, hw), generator=gen, device=dev,
                         dtype=torch.int8)
    scales = 0.002 + 0.02 * torch.rand(s, 2, 16, c, generator=gen, device=dev)
    extra = _randn(gen, dev, s, 16, heads, hw)
    extra[:, 10:] = float("-inf")  # slots not yet visible; the sink always is
    pe_v = _randn(gen, dev, s, 16, c)
    args = (q, data, scales, extra, pe_v, (c // heads) ** -0.5, heads)
    before = _build.launch_counts["stream_attention_int8"]
    out = stream_window_attention_int8(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["stream_attention_int8"] == before + 1
    assert _rel(out, stream_window_attention_plain(*args)) < ATTN_TOL


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 8, 2, 112, device=dev, dtype=torch.bfloat16)  # D = 112: no tile width
    with pytest.raises(ValueError):
        flash_attention(q, q, q, 0.1)
    with pytest.raises(TypeError):
        flash_attention(q.float(), q.float(), q.float(), 0.1)
    x = torch.zeros(1, 8, 8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # Cout must be 64
        conv3x3(x, torch.zeros(32, 64, 3, 3, device=dev, dtype=torch.bfloat16))
    with pytest.raises(NotImplementedError):  # a bias has no kernel yet
        dot_product_attention(q[..., :64], q[..., :64], q[..., :64], bias=torch.zeros((), device=dev))
    s, hw, c = 2, 8, 16
    with pytest.raises(NotImplementedError):  # a float cache has no kernel yet
        stream_window_attention(
            torch.zeros(s, hw, c, device=dev, dtype=torch.bfloat16),
            torch.zeros(s, 2, 16, c, hw, device=dev, dtype=torch.bfloat16),
            torch.zeros(s, c, device=dev), torch.zeros(s, 16, c, device=dev),
            torch.zeros(s, 16, c, device=dev), torch.zeros(s, 16, device=dev), 2,
        )
