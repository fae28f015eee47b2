"""The training pair's routes and the numerics of the tiled route.

``train_route`` at every shape a training step at 256x256 gives the pair
and at the short route's edge. Then the argument for the tiled route's
products, held on the CPU: the kernel splits each fp32 operand into a TF32
big part and a TF32 remainder (round to nearest, ties away from zero, to a
10-bit mantissa, as ``cvt.rna.tf32.f32`` rounds) and sums three TF32
products (``a_small b_big + a_big b_small + a_big b_big``). Emulated here
through an int32 view, that sum over D = 160 products of normal values
stays within 1e-6 of the fp64 dot product, relative to the sum of the
terms' magnitudes; a single TF32 product does not.
"""

from __future__ import annotations

import numpy as np
import pytest

from live2diff_tpu_torch.ops.flash_train import MAX_HEAD_DIM, SHORT_MAX, train_route

# (N, Sq, Sk, H, D) of a training step at 256x256, batch 2, clip 4, and the
# route each takes: the spatial self- and cross-attentions at the four
# latent levels (N = 8 frames), the clip-mode temporal attentions (N = 2 x HW)
STEP_SHAPES = [
    ((8, 1024, 1024, 8, 40), "tiled"), ((8, 256, 256, 8, 80), "tiled"),
    ((8, 64, 64, 8, 160), "tiled"), ((8, 16, 16, 8, 160), "short"),
    ((8, 1024, 77, 8, 40), "tiled"), ((8, 256, 77, 8, 80), "tiled"),
    ((8, 64, 77, 8, 160), "tiled"), ((8, 16, 77, 8, 160), "tiled"),
    ((2048, 4, 4, 8, 40), "short"), ((512, 4, 4, 8, 80), "short"),
    ((128, 4, 4, 8, 160), "short"), ((32, 4, 4, 8, 160), "short"),
]


@pytest.mark.parametrize("shape,route", STEP_SHAPES, ids=[str(s) for s, _ in STEP_SHAPES])
def test_route_at_the_training_step_shapes(shape, route):
    _, sq, sk, _, d = shape
    assert train_route(sq, sk, d) == route


@pytest.mark.parametrize("sq,sk,route", [
    (SHORT_MAX, SHORT_MAX, "short"), (SHORT_MAX + 1, SHORT_MAX + 1, "tiled"),
    (SHORT_MAX, SHORT_MAX + 1, "tiled"), (SHORT_MAX + 1, SHORT_MAX, "tiled"),
    (1, 1, "short"), (1, SHORT_MAX + 1, "tiled"),
])
@pytest.mark.parametrize("d", [1, 17, MAX_HEAD_DIM])
def test_route_at_the_edge(sq, sk, route, d):
    assert train_route(sq, sk, d) == route


def test_short_route_holds_the_clip_mode_rows():
    """The clip-mode temporal attention (S = 4, the clip length) and the 4 x 4
    latent (S = 16) fit the short route; its bound is 32 (8 lanes a row, 256
    threads a CTA)."""
    assert 16 <= SHORT_MAX <= 32


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """fp32 to TF32 (10 mantissa bits) by round to nearest, ties away from
    zero: half an ulp of TF32 added to the magnitude's bits, the low 13 bits
    cleared (the sign bit sits apart, so the same add rounds both signs
    away from zero)."""
    bits = np.asarray(x, np.float32).view(np.int32)
    return ((bits + np.int32(0x1000)) & np.int32(-0x2000)).view(np.float32)


def split_tf32(x: np.ndarray):
    big = rna_tf32(x)
    return big, rna_tf32(x - big)


def test_rna_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's ulp at 1
    cases = {
        one + ulp * np.float32(0.25): one,       # below half: down
        one + ulp * np.float32(0.75): one + ulp,  # above half: up
        one + ulp * np.float32(0.5): one + ulp,   # a tie: away from zero
        -(one + ulp * np.float32(0.5)): -(one + ulp),
        np.float32(3.0): np.float32(3.0),         # exact
        np.float32(0.0): np.float32(0.0),
    }
    for x, want in cases.items():
        assert rna_tf32(np.array([x], np.float32))[0] == want, x
    # every result has 10 mantissa bits or fewer
    x = np.random.RandomState(0).randn(1000).astype(np.float32)
    assert not (rna_tf32(x).view(np.int32) & 0x1FFF).any()
    assert np.abs(rna_tf32(x) - x).max() <= np.abs(x).max() * 2.0 ** -11


def _dot_errors(rows: int = 256, d: int = 160, seed: int = 0):
    """Per-row error of the 3xTF32 and the single-TF32 dot product against
    fp64, over the sum of the terms' magnitudes. The TF32 products are
    exact in fp64 (11 x 11 significant bits), so the sums in fp64 leave only
    the rounding of the operands."""
    rs = np.random.RandomState(seed)
    a = rs.randn(rows, d).astype(np.float32)
    b = rs.randn(rows, d).astype(np.float32)
    exact = (a.astype(np.float64) * b).sum(1)
    size = np.abs(a.astype(np.float64) * b).sum(1)
    (ab, as_), (bb, bs) = split_tf32(a), split_tf32(b)
    f64 = lambda x: x.astype(np.float64)  # noqa: E731
    three = (f64(as_) * f64(bb) + f64(ab) * f64(bs) + f64(ab) * f64(bb)).sum(1)
    single = (f64(ab) * f64(bb)).sum(1)
    return np.abs(three - exact) / size, np.abs(single - exact) / size


def test_three_tf32_products_keep_fp32_accuracy():
    three, single = _dot_errors()
    assert three.max() < 1e-6
    # one TF32 product rounds each operand to 11 significant bits
    assert single.max() > 1e-5
    assert np.median(single) > 10 * three.max()


def test_fp32_accumulation_of_three_tf32_products_matches_an_fp32_dot():
    """The mma sums its three products in fp32: that sum, in the kernel's
    order (small terms first), is as close to fp64 as numpy's fp32 dot."""
    rs = np.random.RandomState(1)
    a, b = (rs.randn(64, 160).astype(np.float32) for _ in range(2))
    (ab, as_), (bb, bs) = split_tf32(a), split_tf32(b)
    acc = np.zeros(64, np.float32)
    for i in range(0, 160, 8):  # one m16n8k8 step a slice of 8
        sl = slice(i, i + 8)
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            acc = (acc + (x[:, sl] * y[:, sl]).sum(1, dtype=np.float32)).astype(np.float32)
    exact = (a.astype(np.float64) * b).sum(1)
    size = np.abs(a.astype(np.float64) * b).sum(1)
    fp32 = np.einsum("rd,rd->r", a, b).astype(np.float64)
    err = np.abs(acc - exact) / size
    assert err.max() < 1e-6
    assert err.max() < 4 * max((np.abs(fp32 - exact) / size).max(), 2.0 ** -24)
