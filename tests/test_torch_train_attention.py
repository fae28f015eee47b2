"""The attention's training path: the fp32 flash pair's plain versions held
to autograd and to ``jax.grad`` of the JAX package's attention, the route
that sends a call to ``FlashAttentionTrain``, and the guard that stops a
gradient through any kernel without a backward."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live2diff_tpu.ops.attention import dot_product_attention as jax_attention
from live2diff_tpu_torch.ops import _build, attention as attn_mod
from live2diff_tpu_torch.ops.attention import attention_route, dot_product_attention
from live2diff_tpu_torch.ops.conv import conv3x3
from live2diff_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_plain, flash_self_attention, flash_self_attention_int8,
    quantize_groups_cuda,
)
from live2diff_tpu_torch.ops.flash_train import (
    FlashAttentionTrain, flash_train_bwd, flash_train_bwd_plain, flash_train_fwd,
    flash_train_fwd_plain,
)
from live2diff_tpu_torch.ops.norm import group_norm, layer_norm_rows
from live2diff_tpu_torch.ops.stream_attention import (
    stream_window_attention_bf16, stream_window_attention_int8,
)

# (leading dims, Sq, Sk, H, D): the clip-mode temporal attention (rank 5,
# S = 4, the spatial positions folded in), a cross-attention over 77 text
# tokens, an S = 256 self-attention, and head widths from 2 to 160 (17: a
# width no tile divides)
SHAPES = {
    "temporal": ((2, 16), 4, 4, 2, 8),
    "cross77": ((2,), 64, 77, 2, 40),
    "self256": ((1,), 256, 256, 2, 80),
    "d2": ((3,), 16, 16, 1, 2),
    "d17": ((2,), 33, 70, 3, 17),
    "d160": ((1,), 64, 77, 1, 160),
}
# fp32 on both sides; only the order of the sums differs
TOL = 2e-5


def _inputs(lead, sq, sk, h, d, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(*lead, sq, h, d).astype(np.float32)
    k = rs.randn(*lead, sk, h, d).astype(np.float32)
    v = rs.randn(*lead, sk, h, d).astype(np.float32)
    do = rs.randn(*lead, sq, h, d).astype(np.float32)
    return q, k, v, do


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _jax_vjp(q, k, v, do):
    out, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c), q, k, v)
    return (np.asarray(out), *(np.asarray(g) for g in vjp(jnp.asarray(do))))


@pytest.mark.parametrize("case", list(SHAPES))
def test_plain_pair_matches_autograd_and_jax_grad(case):
    lead, sq, sk, h, d = SHAPES[case]
    q, k, v, do = _inputs(lead, sq, sk, h, d)
    fold = lambda x: torch.from_numpy(x).reshape(-1, *x.shape[-3:])  # noqa: E731
    qt, kt, vt, dot = map(fold, (q, k, v, do))
    scale = d ** -0.5

    out, lse = flash_train_fwd_plain(qt, kt, vt, scale)
    assert lse.shape == (qt.shape[0], h, sq) and lse.dtype == torch.float32
    logits = torch.einsum("nqhd,nkhd->nhqk", qt.double(), kt.double()) * scale
    assert _rel(lse, torch.logsumexp(logits, -1)) < TOL
    grads = flash_train_bwd_plain(qt, kt, vt, out, lse, dot, scale)

    # torch autograd of the dense forward the CPU route runs
    leaves = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
    ref = flash_attention_plain(*leaves, scale)
    ref.backward(dot)
    assert _rel(out, ref.detach()) < TOL
    for g, leaf in zip(grads, leaves):
        assert _rel(g, leaf.grad) < TOL

    # jax.grad (a vjp) of the JAX package's attention, at the caller's rank
    j_out, *j_grads = _jax_vjp(q, k, v, do)
    assert _rel(out.reshape(j_out.shape), j_out) < TOL
    for g, jg in zip(grads, j_grads):
        assert _rel(g.reshape(jg.shape), jg) < TOL


def test_flash_attention_train_carries_the_gradient_on_cpu():
    """The autograd Function over the pair (its plain versions on the CPU)
    against jax.grad through the temporal shape at rank 5."""
    lead, sq, sk, h, d = SHAPES["temporal"]
    q, k, v, do = _inputs(lead, sq, sk, h, d, seed=1)
    leaves = [torch.from_numpy(x.reshape(-1, *x.shape[-3:])).requires_grad_(True)
              for x in (q, k, v)]
    out = FlashAttentionTrain.apply(*leaves, d ** -0.5)
    out.backward(torch.from_numpy(do.reshape(out.shape)))
    j_out, *j_grads = _jax_vjp(q, k, v, do)
    assert _rel(out.detach().reshape(j_out.shape), j_out) < TOL
    for leaf, jg in zip(leaves, j_grads):
        assert _rel(leaf.grad.reshape(jg.shape), jg) < TOL


def test_cpu_calls_take_the_plain_version_and_count_nothing(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"built {name} on the CPU"))
    before = dict(_build.launch_counts)
    q, k, v, do = (torch.from_numpy(x) for x in _inputs((2,), 8, 8, 2, 4))
    out, lse = flash_train_fwd(q, k, v, 0.5)
    torch.testing.assert_close(out, flash_train_fwd_plain(q, k, v, 0.5)[0])
    grads = flash_train_bwd(q, k, v, out, lse, do, 0.5)
    for g, r in zip(grads, flash_train_bwd_plain(q, k, v, out, lse, do, 0.5)):
        torch.testing.assert_close(g, r)
    assert _build.launch_counts == before


# -- the route -----------------------------------------------------------------


def _qkv(dtype, grad=False, sq=16, sk=16, lead=(2,)):
    q, k, v, _ = _inputs(lead, sq, sk, 2, 8)
    return [torch.from_numpy(x).to(dtype).requires_grad_(grad) for x in (q, k, v)]


def test_route_on_cuda_sends_fp32_and_gradient_calls_to_the_training_kernels():
    route = lambda *a, **kw: attention_route(*a, **kw, cuda=True)  # noqa: E731
    assert route(*_qkv(torch.float32), None, "dmajor") == "train"
    assert route(*_qkv(torch.float32, grad=True), None, "dmajor") == "train"
    with torch.no_grad():
        assert route(*_qkv(torch.float32, grad=True), None, "dmajor") == "train"
        assert route(*_qkv(torch.bfloat16, grad=True), None, "dmajor") == "dmajor"
    # a bf16 call without a gradient keeps the d-major kernel, as before
    assert route(*_qkv(torch.bfloat16), None, "dmajor") == "dmajor"
    # the gated variants keep their calls unless fp32 or a gradient
    gated = dict(sq=1024, sk=1024)
    assert route(*_qkv(torch.bfloat16, **gated), None, "smajor") == "smajor"
    assert route(*_qkv(torch.bfloat16, **gated), None, "int8") == "int8"
    assert route(*_qkv(torch.float32, **gated), None, "int8") == "train"
    # a bias takes the dense version, which autograd differentiates
    bias = torch.zeros(1, 1, 16, 16)
    assert route(*_qkv(torch.bfloat16, grad=True), bias, "dmajor") == "dense"
    # a gradient through a dtype the training kernels do not take raises
    with pytest.raises(TypeError, match="fp32"):
        route(*_qkv(torch.bfloat16, grad=True), None, "dmajor")
    with pytest.raises(TypeError, match="fp32"):
        route(*[x.detach() if i else x for i, x in enumerate(_qkv(torch.float16, grad=True))],
              None, "dmajor")


def test_route_on_cpu_is_unchanged():
    route = lambda *a: attention_route(*a, cuda=False)  # noqa: E731
    assert route(*_qkv(torch.float32, grad=True), None, "dmajor") == "plain"
    assert route(*_qkv(torch.bfloat16, grad=True), None, "dmajor") == "plain"
    assert route(*_qkv(torch.float32, sq=1024, sk=1024), None, "smajor") == "smajor"
    assert route(*_qkv(torch.float32), torch.zeros(1, 1, 16, 16), "dmajor") == "dense"


def test_cuda_tensors_needing_a_gradient_go_through_flash_attention_train(monkeypatch):
    """dot_product_attention on (patched) CUDA tensors at rank 5: the call
    folds the leading dims and goes to FlashAttentionTrain with contiguous
    [N, S, H, D] tensors; nothing else is launched."""
    calls = []

    class Spy:
        @staticmethod
        def apply(q, k, v, scale):
            calls.append((tuple(q.shape), q.is_contiguous(), scale))
            return flash_train_fwd_plain(q, k, v, scale)[0]

    def no_launch(*args, **kwargs):
        raise AssertionError("a training call reached another kernel")

    lead, sq, sk, h, d = SHAPES["temporal"]
    q, k, v, _ = _inputs(lead, sq, sk, h, d, seed=2)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    monkeypatch.setattr(attn_mod, "FlashAttentionTrain", Spy)
    monkeypatch.setattr(attn_mod, "flash_attention", no_launch)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    out = dot_product_attention(qt, kt, vt)
    monkeypatch.undo()
    assert calls == [((32, 4, 2, 8), True, 8 ** -0.5)]
    j_out = np.asarray(jax_attention(q, k, v))
    assert out.shape == j_out.shape and _rel(out.detach(), j_out) < TOL


# -- the guard -----------------------------------------------------------------


def _t(*shape, dtype=torch.bfloat16, seed=0):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)


def _wrapper_calls():
    """Every kernel wrapper but the training pair, called at a shape it takes;
    ``g`` makes the first tensor argument require grad."""
    q4 = lambda g: _t(2, 64, 2, 8).requires_grad_(g)  # noqa: E731
    bhsd = lambda g: _t(2, 2, 128, 8).requires_grad_(g)  # noqa: E731
    cache8 = torch.zeros(2, 2, 16, 16, 8, dtype=torch.int8)
    return {
        "flash_attention": lambda g: flash_attention(q4(g), q4(False), q4(False), 0.3),
        "flash_attention_smajor": lambda g: flash_self_attention(
            bhsd(g), bhsd(False), bhsd(False), 0.3),
        "flash_attention_int8": lambda g: flash_self_attention_int8(
            bhsd(g), bhsd(False), bhsd(False), 0.3),
        "flash_attention_int8_quantize": lambda g: quantize_groups_cuda(bhsd(g), bhsd(False)),
        "stream_attention_int8": lambda g: stream_window_attention_int8(
            _t(2, 8, 16).requires_grad_(g), cache8, _t(2, 2, 16, 16, dtype=torch.float32),
            _t(2, 16, 2, 8, dtype=torch.float32), _t(2, 16, 16, dtype=torch.float32), 0.25, 2),
        "stream_attention_bf16": lambda g: stream_window_attention_bf16(
            _t(2, 8, 16).requires_grad_(g), _t(2, 2, 16, 16, 8),
            _t(2, 16, 2, 8, dtype=torch.float32), _t(2, 16, 16, dtype=torch.float32), 0.25, 2),
        "conv3x3": lambda g: conv3x3(_t(1, 8, 8, 64).requires_grad_(g), _t(64, 64, 3, 3)),
        "conv3x3_s2": lambda g: conv3x3(_t(1, 8, 8, 64).requires_grad_(g), _t(64, 64, 3, 3),
                                        stride=2),
        "layer_norm": lambda g: layer_norm_rows(_t(4, 64).requires_grad_(g), _t(64), _t(64)),
        "group_norm": lambda g: group_norm(_t(2, 16, 64).requires_grad_(g), _t(64), _t(64),
                                           groups=8),
    }


@pytest.mark.parametrize("name", list(_wrapper_calls()))
def test_a_gradient_through_a_kernel_without_backward_raises(monkeypatch, name):
    """With the tensors taken for CUDA ones, each wrapper refuses a call that
    needs a gradient before it launches anything; without a gradient it
    goes on to its launch (stopped here at the build)."""
    built = []

    def fake_load(lib):
        built.append(lib)
        raise RuntimeError("launch reached")

    call = _wrapper_calls()[name]
    monkeypatch.setattr(_build, "load", fake_load)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(RuntimeError, match="has no backward"):
        call(True)
    assert built == []
    with torch.no_grad():
        with pytest.raises(Exception) as info:
            call(True)
    assert "has no backward" not in str(info.value)


def test_the_guard_itself():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward"):
        _build.no_grad_through("k", None, torch.ones(2), x)
    _build.no_grad_through("k", None, torch.ones(2), x.detach())
    with torch.no_grad():
        _build.no_grad_through("k", x)
    with torch.inference_mode():
        _build.no_grad_through("k", x)
