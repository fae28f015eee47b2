"""The attention's training kernels and the trainer on the card.

Needs an NVIDIA Hopper GPU and ``nvcc``; without a CUDA device each test
skips. ``flash_train_fwd`` (O and lse) and ``flash_train_bwd`` (dq, dk, dv)
against their plain versions on both routes (``train_route``: short where
Sq and Sk are at most ``SHORT_MAX``, tiled with 3xTF32 products otherwise):
at the 12 shapes of a training step at 256x256 (N cut to at most 64), at
S = SHORT_MAX and SHORT_MAX + 1, at head widths 1, 17 and 144 and at ragged
shapes (lengths that are not multiples of the 64-row tiles, Sq != Sk);
repeated backward launches bit for bit on each route (no atomics), the
launches by route, the autograd route through ``dot_product_attention``,
the guard on the other kernels, and a tiny trainer's step on the card
against the CPU. Run them on the card from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train_cuda.py

Tolerance: 1e-4 of the plain version's largest value. Both sides compute
in fp32 (the plain version's products with TF32 off) and differ only in
the order of their sums.
"""

from __future__ import annotations

import pytest
import torch

from live2diff_tpu_torch.ops import _build
from live2diff_tpu_torch.ops.attention import dot_product_attention
from live2diff_tpu_torch.ops.flash_attention import flash_attention_plain
from live2diff_tpu_torch.ops import flash_train as ft
from live2diff_tpu_torch.ops.flash_train import (
    SHORT_MAX, flash_train_bwd, flash_train_bwd_plain, flash_train_fwd, flash_train_fwd_plain,
    train_route,
)

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False  # full-fp32 plain references
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(out, ref) -> float:
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _inputs(dev, n, sq, sk, h, d, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda s: torch.randn(n, s, h, d, generator=gen, device=dev)  # noqa: E731
    return r(sq), r(sk), r(sk), r(sq)


# (N, Sq, Sk, H, D) of a training step at 256x256, batch 2, clip 4: the
# spatial self- and cross-attentions at the four latent levels (N = 8
# frames), then the clip-mode temporal attentions (N = 2 x HW, cut to 64)
STEP_SHAPES = [
    (8, 1024, 1024, 8, 40), (8, 256, 256, 8, 80), (8, 64, 64, 8, 160), (8, 16, 16, 8, 160),
    (8, 1024, 77, 8, 40), (8, 256, 77, 8, 80), (8, 64, 77, 8, 160), (8, 16, 77, 8, 160),
    (64, 4, 4, 8, 40), (64, 4, 4, 8, 80), (64, 4, 4, 8, 160), (32, 4, 4, 8, 160),
]
T = SHORT_MAX


@pytest.mark.parametrize("n,sq,sk,h,d", STEP_SHAPES + [
    (3, T, T, 4, 40), (3, T + 1, T + 1, 4, 40),  # the routes' edge
    (2, T, T + 1, 2, 24), (2, T + 1, 3, 2, 24),
    (5, 4, 4, 3, 1), (5, 4, 4, 3, 17), (5, 7, 5, 2, 144),  # ragged D, short
    (3, 4, 4, 8, 36), (7, 3, 4, 5, 40),                    # odd heads and rows
    (2, 70, 33, 2, 1), (2, 70, 70, 2, 17), (1, 90, 50, 2, 144),  # ragged D, tiled
    (2, 100, 77, 3, 40),     # ragged query tile, the text length
    (1, 65, 130, 2, 80),     # one row past a tile, ragged key tiles
    (2, 256, 256, 2, 160),   # the widest head
    (3, 17, 9, 1, 1),
    (1, 64, 64, 4, 17),
    (2, 1, 5, 2, 144),
    (1, 300, 1, 1, 64),
])
def test_training_pair_matches_plain(dev, n, sq, sk, h, d):
    q, k, v, do = _inputs(dev, n, sq, sk, h, d, seed=sq * 1000 + d)
    scale = d ** -0.5
    route = train_route(sq, sk, d)
    assert route == ("short" if max(sq, sk) <= T else "tiled")
    before = dict(ft.route_counts)
    out, lse = flash_train_fwd(q, k, v, scale)
    ref_out, ref_lse = flash_train_fwd_plain(q, k, v, scale)
    torch.cuda.synchronize()
    assert _rel(out, ref_out) < TOL and _rel(lse, ref_lse) < TOL
    grads = flash_train_bwd(q, k, v, out, lse, do, scale)
    refs = flash_train_bwd_plain(q, k, v, ref_out, ref_lse, do, scale)
    torch.cuda.synchronize()
    # one key: P = 1, so dS = dO.v - delta = 0 exactly and dq = dk = 0, of
    # terms that cancel; both sides give only their rounding. Those two are
    # held against the size of the terms, scale |dO.v| |k| for dq and
    # scale |dO.v| |q| sqrt(Sq) for dk (a sum over the queries)
    dp = (do * v).sum(-1).abs().max() if sk == 1 else None
    terms = {"q": lambda: scale * dp * k.abs().max(),
             "k": lambda: scale * dp * q.abs().max() * sq ** 0.5}
    for g, r, what in zip(grads, refs, "qkv"):
        assert g.shape == r.shape, what
        if sk == 1 and what in terms:
            assert (g - r).abs().max() < TOL * terms[what](), what
        else:
            assert _rel(g, r) < TOL, what
    assert {k: ft.route_counts[k] - before[k] for k in before} == {
        f"{w}:{r}": int(r == route) for w in ("flash_train_fwd", "flash_train_bwd")
        for r in ("short", "tiled")}


@pytest.mark.parametrize("route,shape", [("tiled", (8, 1024, 1024, 8, 40)),
                                         ("short", (2048, 4, 4, 8, 40)),
                                         ("short", (8, 16, 16, 8, 160))])
def test_backward_repeats_bit_for_bit(dev, route, shape):
    n, sq, sk, h, d = shape
    assert train_route(sq, sk, d) == route
    q, k, v, do = _inputs(dev, n, sq, sk, h, d, seed=3)
    out, lse = flash_train_fwd(q, k, v, d ** -0.5)
    first = flash_train_bwd(q, k, v, out, lse, do, d ** -0.5)
    for _ in range(3):
        again = flash_train_bwd(q, k, v, out, lse, do, d ** -0.5)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_launches_by_route(dev):
    """One counted launch a call by wrapper and by route; the device kernels
    of each in a profile: one on the short route, the forward's one and the
    backward's two (dQ with delta, then dK and dV) on the tiled."""
    from torch.profiler import ProfilerActivity, profile

    calls = {"short": _inputs(dev, 64, 4, 4, 8, 40), "tiled": _inputs(dev, 2, 100, 77, 2, 40)}
    _build.reset_launch_counts()
    before = dict(ft.route_counts)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for q, k, v, do in calls.values():
            out, lse = flash_train_fwd(q, k, v, 0.2)
            flash_train_bwd(q, k, v, out, lse, do, 0.2)
        torch.cuda.synchronize()
    assert _build.launch_counts["flash_train_fwd"] == 2
    assert _build.launch_counts["flash_train_bwd"] == 2
    assert {k: ft.route_counts[k] - before[k] for k in before} == {
        k: 1 for k in before}
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA for _ in range(e.count)]
    for pat, n in (("flash_train_short_fwd_kernel<", 1), ("flash_train_short_bwd_kernel<", 1),
                   ("flash_train_tiled_fwd_kernel<", 1), ("flash_train_tiled_dq_kernel<", 1),
                   ("flash_train_tiled_dkdv_kernel<", 1), ("flash_train_tiled_fwd_split", 0)):
        assert sum(pat in name for name in names) == n, (pat, names)


def test_gradient_through_dot_product_attention(dev):
    """fp32 leaves on the card: one forward and one backward launch, and
    the gradient of the plain dense version."""
    q, k, v, do = _inputs(dev, 2, 16, 77, 2, 40, seed=4)
    q5 = q.reshape(2, 1, 16, 2, 40)
    leaves = [x.clone().requires_grad_(True) for x in (q5, k[:, None], v[:, None])]
    _build.reset_launch_counts()
    out = dot_product_attention(*leaves)
    out.backward(do.reshape(out.shape))
    assert _build.launch_counts["flash_train_fwd"] == 1
    assert _build.launch_counts["flash_train_bwd"] == 1
    assert _build.launch_counts["flash_attention"] == 0
    refs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    ref = flash_attention_plain(*refs, 40 ** -0.5)
    ref.backward(do)
    assert _rel(out.detach().reshape(ref.shape), ref.detach()) < TOL
    for leaf, r in zip(leaves, refs):
        assert _rel(leaf.grad.reshape(r.grad.shape), r.grad) < TOL


def test_inference_routes_are_unchanged_and_the_guard_holds(dev):
    q, k, v, _ = _inputs(dev, 2, 64, 64, 2, 40, seed=5)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    _build.reset_launch_counts()
    with torch.no_grad():
        dot_product_attention(qb, kb, vb)
    dot_product_attention(qb, kb, vb)
    assert _build.launch_counts["flash_attention"] == 2
    assert _build.launch_counts["flash_train_fwd"] == 0
    with pytest.raises(TypeError, match="fp32"):
        dot_product_attention(qb.requires_grad_(True), kb, vb)
    from live2diff_tpu_torch.ops.flash_attention import flash_attention

    with pytest.raises(RuntimeError, match="has no backward"):
        flash_attention(qb, kb, vb, 0.2)


def test_tiny_trainer_step_on_the_card_matches_the_cpu(dev):
    """One step of the tiny trainer (every weight random, so every motion
    gradient is nonzero) on the card and on the CPU, same t and noise."""
    from live2diff_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
    from live2diff_tpu_torch.parallel.train import (
        alphas_cumprod, diffusion_loss, is_motion_param, make_optimizer,
    )
    from live2diff_tpu_torch.train import TINY_UNET

    gen = torch.Generator().manual_seed(0)
    cpu = UNet3DConditionModel(UNetConfig(**TINY_UNET))
    with torch.no_grad():
        for p in cpu.parameters():
            p.normal_(0.0, p[0].numel() ** -0.5 if p.dim() > 1 else 0.1, generator=gen)
    card = UNet3DConditionModel(UNetConfig(**TINY_UNET)).to(dev)
    card.load_state_dict(cpu.state_dict())
    batch = {"latents": torch.randn(2, 4, 8, 8, 4, generator=gen),
             "text": torch.randn(2, 7, 12, generator=gen),
             "depth": torch.randn(2, 4, 8, 8, 4, generator=gen)}
    t, noise = torch.tensor([10, 700]), torch.randn(2, 4, 8, 8, 4, generator=gen)
    losses, grads = [], []
    for unet, where in ((cpu, "cpu"), (card, dev)):
        make_optimizer(unet)
        _build.reset_launch_counts()
        loss = diffusion_loss(unet, {k: x.to(where) for k, x in batch.items()},
                              alphas_cumprod(device=where), t=t.to(where),
                              noise=noise.to(where))
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.cpu() for n, p in unet.named_parameters()
                      if is_motion_param(n)})
    # 16 spatial transformers (self + cross) and 20 motion modules (2 each)
    assert _build.launch_counts["flash_train_fwd"] == 72
    assert _build.launch_counts["flash_train_bwd"] == 70  # all but the first transformer's
    assert abs(losses[1] - losses[0]) < 1e-5 * abs(losses[0])
    for name, g in grads[0].items():
        assert _rel(grads[1][name], g) < 1e-3, name
