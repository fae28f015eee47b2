"""The attention's training kernels and the trainer on the card.

Needs an NVIDIA Hopper GPU and ``nvcc``; without a CUDA device each test
skips. ``flash_train_fwd`` (O and lse) and ``flash_train_bwd`` (dq, dk, dv)
against their plain versions at ragged shapes (lengths that are not
multiples of the 64-row tiles, head widths from 1 to 160, Sq != Sk),
repeated backward launches bit for bit (no atomics), the autograd route
through ``dot_product_attention``, the guard on the other kernels, and a
tiny trainer's step on the card against the CPU. Run them on the card from
the repository root:

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
from live2diff_tpu_torch.ops.flash_train import (
    flash_train_bwd, flash_train_bwd_plain, flash_train_fwd, flash_train_fwd_plain,
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


@pytest.mark.parametrize("n,sq,sk,h,d", [
    (64, 4, 4, 8, 40),       # clip-mode temporal attention: S = 4
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


def test_backward_repeats_bit_for_bit(dev):
    q, k, v, do = _inputs(dev, 8, 1024, 1024, 8, 40, seed=3)
    out, lse = flash_train_fwd(q, k, v, 40 ** -0.5)
    first = flash_train_bwd(q, k, v, out, lse, do, 40 ** -0.5)
    for _ in range(3):
        again = flash_train_bwd(q, k, v, out, lse, do, 40 ** -0.5)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


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
