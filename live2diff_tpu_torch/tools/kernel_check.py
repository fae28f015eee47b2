"""On-card kernel selftest: every CUDA kernel of the port against its plain
torch version. The port's counterpart of ``tools/kernel_check.py``.

    python -m live2diff_tpu_torch.tools.kernel_check [--quick]

prints one JSON line ``{"metric": "kernel_selftest", <check>: {"max_rel_err",
"tol", "ok"}, ..., "pass": bool}`` and exits non-zero on a failure;
``chip_smoke.py`` calls ``run_all(quick=True)`` on the card.

The checks, shapes and tolerances are those of the JAX file
(``tools/kernel_check.py:42-200``): the flash entries (s-major, d-major,
int8, and at the 768x512 row's S = 6144 in the full run), stream attention
over a bf16 and an int8 cache at each ``(C, HW)``, the TAESD conv at stride
1 and 2, ``group_norm_silu`` and ``layer_norm_vit577``. Between them they
reach all nine kernels (``KERNELS``); a check passes only if its kernel
launched once. The metric is the JAX one: max |kernel - plain| over
max |plain|. The plain references run on the card in fp32 (TF32 off while
``run_all`` runs); stream attention's is the same function on CPU copies
of its inputs, where the wrappers run their plain versions, as the JAX file
takes the same function with the TPU dispatch disabled.

Two departures, both where a port kernel takes another dtype than the
Pallas one: the GroupNorm and LayerNorm kernels take bf16 scale and bias
(the JAX checks draw fp32 ones), so both sides get the bf16 values.

On a CPU tensor every wrapper runs its plain version, so on the CPU there
is nothing to compare: ``run_all`` raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

EXACT_TOL = 2.5e-2  # bf16 rounding noise, elementwise relative-to-range
INT8_TOL = 8e-2  # quantisation by design

# the nine kernels (``ops/_build.py`` launch counters) the checks reach
KERNELS = ("flash_attention_smajor", "flash_attention", "flash_attention_int8",
           "stream_attention_bf16", "stream_attention_int8", "conv3x3", "conv3x3_s2",
           "group_norm", "layer_norm")


@dataclasses.dataclass(frozen=True)
class Check:
    name: str
    kernel: str  # the launch counter the check must move by one
    tol: float
    case: str  # the input family, as in the JAX file's sections
    shape: tuple


def plan(quick: bool = False) -> List[Check]:
    """The checks of ``run_all(quick)``, in the JAX file's order and shapes."""
    b, h, s, d = (1, 2, 2048, 40) if quick else (2, 8, 4096, 40)
    checks = [Check("flash_smajor", "flash_attention_smajor", EXACT_TOL, "smajor", (b, h, s, d)),
              Check("flash_dmajor", "flash_attention", EXACT_TOL, "dmajor", (b, h, s, d)),
              Check("flash_int8", "flash_attention_int8", INT8_TOL, "int8", (b, h, s, d))]
    if not quick:
        # the 768x512 row's level-0 sequence: non-default divisor blocks
        checks += [Check("flash_dmajor_6144", "flash_attention", EXACT_TOL, "dmajor",
                         (2, h, 6144, d)),
                   Check("flash_int8_6144", "flash_attention_int8", INT8_TOL, "int8",
                         (2, h, 6144, d))]
    # (C, HW): the largest cache layer and the deepest; steps 2, window 16, 8 heads
    for c, hw in [(320, 1024)] if quick else [(320, 4096), (1280, 256)]:
        for cache in ("bf16", "int8"):
            # same int8 cache both sides: the dequant math agrees to bf16 noise
            checks.append(Check(f"stream_attn_{cache}_c{c}_hw{hw}", f"stream_attention_{cache}",
                                EXACT_TOL, f"stream_{cache}", (c, hw)))
    res = 128 if quick else 512
    checks += [Check("taesd_conv64", "conv3x3", EXACT_TOL, "conv", (res, 64, 64)),
               Check("taesd_conv64_s2", "conv3x3_s2", EXACT_TOL, "conv_s2", (res, 64, 64))]
    checks.append(Check("group_norm_silu", "group_norm", EXACT_TOL, "group_norm",
                        (2, 1024, 320) if quick else (2, 4096, 320)))
    # 577 ViT tokens: rows that are no multiple of a block
    checks.append(Check("layer_norm_vit577", "layer_norm", EXACT_TOL, "layer_norm",
                        (8 * 577, 768)))
    return checks


def _relerr(got, want) -> float:
    """max |got - want| / (max |want| + 1e-6), in fp32: the JAX file's metric."""
    got, want = (np.asarray(t.detach().float().cpu() if isinstance(t, torch.Tensor) else t,
                            np.float32) for t in (got, want))
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want))) + 1e-6)


def _sdpa_ref(q, k, v, scale):
    """The JAX file's ``sdpa_ref`` over [B, H, S, D]: fp32 logits and
    softmax, probabilities cast to bf16, fp32 value product."""
    from ..ops.flash_attention import flash_attention_plain

    t = lambda x: x.transpose(1, 2)  # noqa: E731  [B, S, H, D]
    return t(flash_attention_plain(t(q), t(k), t(v), scale))


def _flash(check: Check, rand) -> tuple:
    from ..ops import flash_attention as fa

    b, h, s, d = check.shape
    q, k, v = rand(b, h, s, d), rand(b, h, s, d), rand(b, h, s, d)
    scale = d ** -0.5
    want = _sdpa_ref(q, k, v, scale)
    if check.case == "smajor":
        got = lambda: fa.flash_self_attention(q, k, v, scale)  # noqa: E731
    elif check.case == "dmajor":
        t = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
        got = lambda: fa.flash_attention(t(q), t(k), t(v), scale).transpose(1, 2)  # noqa: E731
    else:
        got = lambda: fa.flash_self_attention_int8(q, k, v, scale,  # noqa: E731
                                                   block_k=min(s, 4096))
    return got, want


def _stream(check: Check, rand) -> tuple:
    from ..ops.attention import stream_window_attention

    c, hw = check.shape
    steps, window, heads = 2, 16, 8
    q = rand(steps, hw, c)
    cache = rand(steps, 2, window, c, hw)
    pe_q, pe_k, pe_v = (rand(steps, c, dtype=torch.float32),
                        rand(steps, window, c, dtype=torch.float32),
                        rand(steps, window, c, dtype=torch.float32))
    bias = torch.where(torch.arange(window, device=q.device) < 12, 0.0,
                       float("-inf"))[None].expand(steps, -1).contiguous()
    if check.case == "stream_int8":
        # per-(slot, channel) scales, as the pipeline quantises its cache
        cf = cache.float()
        sc = cf.abs().amax(dim=4) / 127.0 + 1e-12
        data8 = torch.clamp(torch.round(cf / sc[..., None]), -127, 127).to(torch.int8)
        cache = (data8, sc.float())
    args = (q, cache, pe_q, pe_k, pe_v, bias, heads)
    cpu = [tuple(a.cpu() for a in x) if isinstance(x, tuple)
           else x.cpu() if isinstance(x, torch.Tensor) else x for x in args]
    want = stream_window_attention(*cpu)
    return (lambda: stream_window_attention(*args)), want


def _conv(check: Check, rand) -> tuple:
    from ..ops.conv import conv3x3, conv3x3_plain

    res, cin, cout = check.shape
    x = rand(1, res, res, cin)
    w = (rand(cout, cin, 3, 3).float() * 0.1).to(torch.bfloat16)
    bias = rand(cout, dtype=torch.float32).to(torch.bfloat16)
    if check.case == "conv":
        skip = rand(1, res, res, cout)
        return ((lambda: conv3x3(x, w, bias, skip=skip, relu=True)),
                conv3x3_plain(x, w, bias, skip=skip, relu=True))
    return ((lambda: conv3x3(x, w, bias, relu=False, stride=2)),
            conv3x3_plain(x, w, bias, relu=False, stride=2))


def _norm(check: Check, rand) -> tuple:
    from ..ops import norm

    c = check.shape[-1]
    x = rand(*check.shape)
    g, be = (rand(c, dtype=torch.float32).to(torch.bfloat16) for _ in range(2))
    if check.case == "group_norm":
        return ((lambda: norm.group_norm(x, g, be, 32, 1e-5, "silu")),
                norm.group_norm_plain(x, g, be, 32, 1e-5, "silu"))
    return (lambda: norm.layer_norm_rows(x, g, be, 1e-5)), norm.layer_norm_plain(x, g, be, 1e-5)


_CASES: Dict[str, Callable] = {"smajor": _flash, "dmajor": _flash, "int8": _flash,
                               "stream_bf16": _stream, "stream_int8": _stream,
                               "conv": _conv, "conv_s2": _conv,
                               "group_norm": _norm, "layer_norm": _norm}


def run_all(quick: bool = False, device: Optional[str] = None) -> dict:
    """Every kernel against its plain version on the card (``device``, the
    card by default): ``{check: {"max_rel_err", "tol", "ok"}, "pass": bool}``.
    Raises on the CPU, where the wrappers run the plain versions."""
    from ..builder import resolve_device
    from ..ops import _build

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("kernel_check compares each CUDA kernel with its plain version; on "
                           f"{dev} the wrappers run the plain versions, so nothing is compared")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    results: dict = {}
    try:
        with torch.no_grad():
            for check in plan(quick):
                got_fn, want = _CASES[check.case](check, rand)
                before = _build.launch_counts[check.kernel]
                got = got_fn()
                torch.cuda.synchronize(dev)
                launched = _build.launch_counts[check.kernel] - before
                err = _relerr(got, want)
                results[check.name] = {"max_rel_err": round(err, 6), "tol": check.tol,
                                       "ok": bool(err <= check.tol and launched == 1)}
                del got, want
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    results["pass"] = all(v["ok"] for v in results.values())
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kernel_check", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--quick", action="store_true", help="smaller shapes")
    p.add_argument("--device", default=None, help="the card (default)")
    args = p.parse_args(argv)
    try:
        results = run_all(quick=args.quick, device=args.device)
    except RuntimeError as e:
        print(f"kernel_check: {e}", file=sys.stderr)
        return 2
    print(json.dumps({"metric": "kernel_selftest", **results}))
    return 0 if results["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
