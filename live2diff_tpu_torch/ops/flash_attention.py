"""Flash scaled-dot-product attention: kernel wrappers and plain versions.

Three CUDA entry points replace the three Pallas TPU flash kernels of
``live2diff_tpu/ops/flash_attention.py``:

* ``flash_attention`` (``csrc/flash_attention.cu``) replaces
  ``flash_self_attention_dmajor``: an unmasked SDPA with an online softmax
  in fp32 and bf16 operands. It reads the model's ``[B, S, H, D]`` layout in
  place and takes any Sq and Sk, so every bias-free attention of the UNet
  runs through it on the card. ``flash_attention_plain`` is the same
  function in plain torch (the JAX package's dense path,
  ``ops/attention.py:46-55``).
* ``flash_self_attention`` (the s-major entry of the same source) replaces
  ``flash_self_attention``: the same function over ``[B, H, S, D]``, read
  through strides, with the online softmax updated once per key block of
  ``block_k`` keys, as the Pallas kernel's grid does.
* ``flash_self_attention_int8`` (``csrc/flash_attention_int8.cu``) replaces
  ``flash_self_attention_int8``: Q and K quantised to int8 with one
  symmetric scale per group of ``block_q`` query rows and per group of
  ``block_k`` key rows (the Pallas kernel's tiles), an exact integer Q.K,
  then the fp32 softmax and a bf16 P.V. Two launches a call: a pre-pass
  writes the codes and scales into scratch, then the s-major walk of the
  same Hopper core as the two bf16 entries runs on them with int8 ``wgmma``.

The two ``[B, H, S, D]`` entries take ``scale``, ``block_q`` and ``block_k``
as the JAX functions do, and shrink the blocks with ``pick_block`` to
divisors of the sequence lengths. Their plain versions walk the same
blocks in plain torch.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from . import _build

NAME = "flash_attention"
SMAJOR_NAME = "flash_attention_smajor"
INT8_NAME = "flash_attention_int8"


def pick_block(s: int, target: int, align: int = 128) -> int:
    """Largest block <= ``target`` that divides ``s`` and is a multiple of
    ``align`` (``s`` itself when it is not larger than ``target``); the port's
    copy of ``live2diff_tpu/ops/flash_attention.py:pick_block``."""
    if s <= target:
        return s
    b = target - target % align
    while b > align and s % b:
        b -= align
    return b


# logits the plain version holds at once (the JAX package's dense budget,
# live2diff_tpu/ops/attention.py:28); above it the queries go in blocks
PLAIN_MAX_LOGITS = 1 << 24


def flash_attention_plain(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, H, D]
    v: torch.Tensor,  # [B, Sk, H, D]
    scale: float,
    bias: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Sq, Sk]
) -> torch.Tensor:
    """Dense attention: fp32 logits and softmax, probabilities cast to v's
    dtype, fp32 accumulation of the value product. Returns q's layout in
    v's dtype. Past ``PLAIN_MAX_LOGITS`` logits it takes the queries in
    blocks, each row's softmax over all of its keys at once: the 64x64
    latent's warmup self-attention would otherwise hold 2^30 fp32 logits
    (4 GiB) twice over."""
    b, sq, h, _ = q.shape
    rows = max(1, PLAIN_MAX_LOGITS // (b * h * k.shape[1]))
    if rows >= sq:
        return _dense_plain(q, k, v, scale, bias)
    per_row = bias is not None and bias.dim() >= 2 and bias.shape[-2] == sq
    return torch.cat([
        _dense_plain(q[:, i:i + rows], k, v, scale,
                     bias[..., i:i + rows, :] if per_row else bias)
        for i in range(0, sq, rows)], dim=1)


def _dense_plain(q, k, v, scale, bias):
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(v.dtype)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """softmax(scale q k^T) v over ``[B, S, H, D]`` tensors. Launches the CUDA
    kernel on CUDA tensors (bf16, contiguous, D % 8 == 0, D <= 160); a CPU
    tensor runs the plain version."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, scale)
    _build.no_grad_through(NAME, q, k, v)
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _build.require(t, what, torch.bfloat16, 4)
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {what} is not 16-byte aligned")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if (
        tuple(k.shape) != (b, sk, h, d) or tuple(v.shape) != (b, sk, h, d)
        or d % 8 or d > 160 or (d + 15) // 16 in (7, 9) or b > 65535 or h > 65535
    ):
        raise ValueError(
            f"flash_attention: unsupported shapes q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    fn = lib.flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, sq, sk, d, float(scale), _build.stream_handle(q),
    )
    _build.check(rc, NAME)
    _build.launch_counts[NAME] += 1
    return out


def tensor_map_encode_stats():
    """(host ns spent encoding TMA tensor maps, launches that encoded them)
    summed over both entries of ``csrc/flash_attention.cu`` since it was
    loaded: each launch encodes three maps on the host."""
    fn = _build.load("flash_attention").flash_attention_encode_stats
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_longlong
    calls = ctypes.c_longlong(0)
    ns = fn(ctypes.byref(calls))
    return ns, calls.value


# ---------------------------------------------------------------------------
# [B, H, S, D] entries: s-major and int8-QK
# ---------------------------------------------------------------------------


def _blocks(q: torch.Tensor, k: torch.Tensor, block_q: int, block_k: int, what: str):
    """The JAX functions' blocks: ``pick_block`` of each length, which must
    then divide it."""
    sq, sk = q.shape[2], k.shape[2]
    bq, bk = pick_block(sq, block_q), pick_block(sk, block_k)
    if sq % bq or sk % bk:
        raise ValueError(f"{what}: blocks ({bq}, {bk}) do not divide Sq {sq}, Sk {sk}")
    return bq, bk


def _online_softmax_blocks(
    q: torch.Tensor, v: torch.Tensor, block_q: int, block_k: int,
    logits: Callable[[int, int, int, int], torch.Tensor],
) -> torch.Tensor:
    """The Pallas grid in plain torch: for each block of ``block_q`` query
    rows, an online softmax over key blocks of ``block_k`` keys (fp32 max,
    sum and accumulator; probabilities cast to v's dtype before the value
    product), ``acc * (1 / l)`` at the end. ``logits(q0, q1, k0, k1)`` gives
    the fp32 ``[B, H, q1 - q0, k1 - k0]`` logits of a block pair."""
    b, h, sq, d = q.shape
    sk = v.shape[2]
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    for q0 in range(0, sq, block_q):
        q1 = q0 + block_q
        m = torch.full((b, h, block_q, 1), float("-inf"), device=q.device)
        l = torch.zeros((b, h, block_q, 1), device=q.device)
        acc = torch.zeros((b, h, block_q, d), device=q.device)
        for k0 in range(0, sk, block_k):
            k1 = k0 + block_k
            s = logits(q0, q1, k0, k1)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), v[:, :, k0:k1].float())
            m = m_new
        l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
        out[:, :, q0:q1] = (acc * l_inv).to(q.dtype)
    return out


def flash_self_attention_plain(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, H, Sk, D]
    v: torch.Tensor,  # [B, H, Sk, D]
    scale: float,
    block_q: int = 512,
    block_k: int = 1024,
) -> torch.Tensor:
    """The s-major kernel's plain version: fp32 logits ``q k^T * scale`` and
    an online softmax over key blocks of ``pick_block(Sk, block_k)``."""
    bq, bk = _blocks(q, k, block_q, block_k, "flash_self_attention")
    qf, kf = q.float(), k.float()

    def logits(q0, q1, k0, k1):
        return torch.matmul(qf[:, :, q0:q1], kf[:, :, k0:k1].transpose(-1, -2)) * scale

    return _online_softmax_blocks(q, v, bq, bk, logits)


def quantize_groups(x: torch.Tensor, block: int):
    """Symmetric int8 codes of ``x`` ``[B, H, S, D]`` with one scale per
    group of ``block`` rows of each (b, h): ``s = max(max|x|, 1e-12) / 127``,
    codes ``round(x * (1 / s))`` (half to even). Returns (codes as fp32
    ``[B, H, S, D]``, scales ``[B, H, S // block]``)."""
    b, h, s, d = x.shape
    xg = x.float().reshape(b, h, s // block, block * d)
    amax = torch.clamp_min(xg.abs().amax(dim=-1), 1e-12)
    # a tensor divisor: on CUDA, torch divides by a Python scalar through its
    # reciprocal, which can move a scale by one ulp and with it some codes
    scales = amax / torch.full_like(amax, 127.0)
    codes = torch.round(xg * torch.reciprocal(scales)[..., None])
    return codes.reshape(b, h, s, d), scales


def flash_self_attention_int8_plain(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, H, Sk, D]
    v: torch.Tensor,  # [B, H, Sk, D]
    scale: float,
    block_q: int = 512,
    block_k: int = 1024,
) -> torch.Tensor:
    """The int8-QK kernel's plain version: Q and K quantised per group of
    ``pick_block`` rows, the integer Q.K (exact in fp32: |sum| <= 127^2 D <
    2^24) scaled by ``s_k * s_q * scale``, and an online softmax over the key
    groups."""
    bq, bk = _blocks(q, k, block_q, block_k, "flash_self_attention_int8")
    q8, sq = quantize_groups(q, bq)
    k8, sk = quantize_groups(k, bk)

    def logits(q0, q1, k0, k1):
        dots = torch.matmul(q8[:, :, q0:q1], k8[:, :, k0:k1].transpose(-1, -2))
        factor = sk[:, :, k0 // bk] * sq[:, :, q0 // bq] * scale
        return dots * factor[:, :, None, None]

    return _online_softmax_blocks(q, v, bq, bk, logits)


def _bhsd_launch_args(what: str, q, k, v):
    """Checks of the ``[B, H, S, D]`` CUDA entries; returns the output (q's
    strides) and the 12 strides (b, h, s of q, k, v, out) as a ctypes array."""
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_cuda:
            raise ValueError(f"{what}: expected a CUDA tensor {name}, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: expected bf16 {name}, got {t.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{what}: {name} must be [B, H, S, D] with contiguous, 16-byte aligned rows; "
                f"got shape {tuple(t.shape)} strides {t.stride()}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if (
        tuple(k.shape) != (b, h, sk, d) or tuple(v.shape) != (b, h, sk, d)
        or d % 8 or d > 160 or (d + 15) // 16 in (7, 9) or b > 65535 or h > 65535
    ):
        raise ValueError(
            f"{what}: unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}")
    out = torch.empty_like(q)  # q's strides: the caller's layout
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    return out, (ctypes.c_longlong * 12)(*strides)


def flash_self_attention(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, H, Sk, D]
    v: torch.Tensor,  # [B, H, Sk, D]
    scale: float,
    block_q: int = 512,
    block_k: int = 1024,
) -> torch.Tensor:
    """softmax(scale q k^T) v over ``[B, H, S, D]`` with the s-major blocking.
    Launches the CUDA kernel on CUDA tensors (bf16, rows contiguous and
    16-byte aligned, any other strides: a transposed ``[B, S, H, D]`` view
    needs no copy; D % 8 == 0, D <= 160); a CPU tensor runs the plain
    version. ``block_q`` sets only the Pallas grid, not the result."""
    if not q.is_cuda:
        return flash_self_attention_plain(q, k, v, scale, block_q, block_k)
    _build.no_grad_through(SMAJOR_NAME, q, k, v)
    _, bk = _blocks(q, k, block_q, block_k, "flash_self_attention")
    out, strides = _bhsd_launch_args("flash_self_attention", q, k, v)
    b, h, sq, d = q.shape
    fn = _build.load("flash_attention").flash_attention_smajor
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            b, h, sq, k.shape[2], d, bk, float(scale), _build.stream_handle(q))
    _build.check(rc, SMAJOR_NAME)
    _build.launch_counts[SMAJOR_NAME] += 1
    return out


def _int8_scratch(q, k, bq: int, bk: int):
    """The int8 entries' scratch, one allocation: the int8 codes of Q and K,
    ``[B, H, S, dp]`` with the row pitch dp = D rounded up to 16 bytes (TMA's
    stride unit; the pre-pass zeroes columns past D), then the fp32 scales of
    their groups, ``[B, H, S // block]``. Returns (q8, k8, q scales, k
    scales, dp)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dp = -(-d // 16) * 16
    nq, nk = b * h * sq * dp, b * h * sk * dp
    ns_q, ns_k = b * h * (sq // bq), b * h * (sk // bk)
    buf = torch.empty(nq + nk + 4 * (ns_q + ns_k), dtype=torch.uint8, device=q.device)
    scales = buf[nq + nk:].view(torch.float32)
    return (buf[:nq].view(torch.int8).view(b, h, sq, dp),
            buf[nq:nq + nk].view(torch.int8).view(b, h, sk, dp),
            scales[:ns_q].view(b, h, -1), scales[ns_q:].view(b, h, -1), dp)


def flash_self_attention_int8(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, H, Sk, D]
    v: torch.Tensor,  # [B, H, Sk, D]
    scale: float,
    block_q: int = 512,
    block_k: int = 1024,
) -> torch.Tensor:
    """Unmasked SDPA with int8 Q.K quantised per group of
    ``pick_block(Sq, block_q)`` query rows and ``pick_block(Sk, block_k)``
    key rows. Launches the CUDA kernel on CUDA tensors (as
    ``flash_self_attention`` takes them); a CPU tensor runs the plain
    version."""
    if not q.is_cuda:
        return flash_self_attention_int8_plain(q, k, v, scale, block_q, block_k)
    _build.no_grad_through(INT8_NAME, q, k, v)
    bq, bk = _blocks(q, k, block_q, block_k, "flash_self_attention_int8")
    out, strides = _bhsd_launch_args("flash_self_attention_int8", q, k, v)
    b, h, sq, d = q.shape
    *scratch, dp = _int8_scratch(q, k, bq, bk)
    fn = _build.load("flash_attention_int8").flash_attention_int8
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *(s.data_ptr() for s in scratch), dp, strides, b, h, sq, k.shape[2], d, bq, bk,
            float(scale), _build.stream_handle(q))
    _build.check(rc, INT8_NAME)
    _build.launch_counts[INT8_NAME] += 1
    return out


def quantize_groups_cuda(q: torch.Tensor, k: torch.Tensor, block_q: int = 512,
                         block_k: int = 1024):
    """The int8 entry's pre-pass alone, on CUDA tensors taken as
    ``flash_self_attention_int8`` takes them: the codes and scales of Q's
    groups of ``pick_block(Sq, block_q)`` rows and K's of ``pick_block(Sk,
    block_k)``, which must equal ``quantize_groups``' bit for bit. For
    checking the pre-pass only: no path of the port calls it, and it counts
    no launch. Returns (Q codes ``[B, H, Sq, D]`` int8, Q scales
    ``[B, H, Gq]``, K codes, K scales)."""
    _build.no_grad_through("flash_attention_int8_quantize", q, k)
    bq, bk = _blocks(q, k, block_q, block_k, "quantize_groups_cuda")
    _, strides = _bhsd_launch_args("quantize_groups_cuda", q, k, k)
    b, h, sq, d = q.shape
    q8, k8, s_q, s_k, dp = _int8_scratch(q, k, bq, bk)
    fn = _build.load("flash_attention_int8").flash_attention_int8_quantize
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), k.data_ptr(), q8.data_ptr(), k8.data_ptr(), s_q.data_ptr(),
            s_k.data_ptr(), dp, strides, b, h, sq, k.shape[2], d, bq, bk,
            _build.stream_handle(q))
    _build.check(rc, "flash_attention_int8_quantize")
    return q8[..., :d], s_q, k8[..., :d], s_k
