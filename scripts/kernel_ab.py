#!/usr/bin/env python3
"""Per-call device time of the port's attention, conv and norm kernels, on one GPU.

    python3 scripts/kernel_ab.py [--other DIR] [--reps 20] [--json PATH]
                                 [--only stream|flash|conv|int8|ln|gn|train] [--device]

Times both stream-attention entries (kernels #1 and #2, int8 and bf16
cache) at the four UNet levels of the 512x512 and of the 768x512 stream
step, ``flash_attention`` (d-major, kernel #3) at every shape of the
512x512 stream step and of ``prepare`` that ``chip_smoke.py`` checks,
``flash_self_attention`` (s-major, kernel #4) at its 512x512 and 768x512
shapes, ``conv3x3`` (kernels #6 and #7, stride 1 and 2) at every shape
of ``chip_smoke.py``'s phase 2 (the 512x512 and 768x512 steps and
``prepare``), ``flash_self_attention_int8`` (kernel #5) at its eight phase-2
shapes (phase 6's and the 768x512 step's), and ``layer_norm_rows`` (kernel
#9) at phase 4's ViT shapes and the UNet's shapes of phase 10
(``ln_kernel_sites="all"``), and ``group_norm`` (kernel #8) at the 22
shapes of a 512x512 stream step with ``gn_kernel_sites="all"`` and
prepare's largest, and the fp32 training pair ``flash_train_fwd`` and
``flash_train_bwd`` at the 12 shapes of a training step at 256x256
(``chip_smoke.py`` phase 16), with CUDA events, the L2 cache overwritten
before each call. With
``--other DIR`` (another checkout of the repository, for example a parent
commit unpacked with ``git archive``) both trees are timed on the same card
in turns: this tree, the other, the other, this tree, each in a process of
its own that builds its own kernels. Prints one line per shape with the
mean of each tree's two turns, and the card's name and power limit.
``--only`` times one family of kernels. ``--device`` reads each call's
kernels' own device time from a torch.profiler trace instead of CUDA events
around the call (which also count the launch).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from probe_util import card, cold_timer, device_timer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (C, HW) of stream attention: the four UNet levels at 512x512, then at
# 768x512; 2 denoising steps, 8 heads, a 16-slot window
STREAM = [(320, 4096), (640, 1024), (1280, 256), (1280, 64),
          (320, 6144), (640, 1536), (1280, 384), (1280, 96)]
# (B, Sq, Sk, H, D) of the d-major entry: the stream step's self- and
# cross-attention at the four levels and the ViT, then prepare's shapes
DMAJOR = [
    (2, 4096, 4096, 8, 40), (2, 1024, 1024, 8, 80), (2, 256, 256, 8, 160), (2, 64, 64, 8, 160),
    (2, 4096, 77, 8, 40), (2, 1024, 77, 8, 80), (2, 256, 77, 8, 160), (2, 64, 77, 8, 160),
    (1, 577, 577, 12, 64), (8, 4096, 4096, 8, 40), (4096, 8, 8, 8, 40), (1024, 8, 8, 8, 80),
    (256, 8, 8, 8, 160), (64, 8, 8, 8, 160), (8, 577, 577, 12, 64),
]
# (B, S, D) of the s-major entry, H = 8, blocks (512, 1024)
SMAJOR = [(2, 4096, 40), (2, 1024, 80), (2, 6144, 40), (2, 1536, 80), (8, 6144, 40),
          (8, 1536, 80)]
# (B, S, D) of the int8-QK entry, H = 8, blocks (512, min(S, 4096)): the
# 512x512 step (B = 2) and prepare (B = 8), then the 768x512 step's
INT8 = [(2, 4096, 40), (2, 1024, 80), (8, 4096, 40), (8, 1024, 80), (2, 6144, 40),
        (2, 1536, 80), (8, 6144, 40), (8, 1536, 80)]
# (rows, C, eps) of LayerNorm: the ViT's 577 tokens a frame (one frame a
# step, 8 in prepare), then the UNet's spatial and motion LayerNorms of a
# 512x512 step (2 steps x HW tokens) and of prepare (8 frames)
LN = [(577, 768, 1e-6), (4616, 768, 1e-6), (8192, 320, 1e-5), (2048, 640, 1e-5),
      (512, 1280, 1e-5), (128, 1280, 1e-5), (32768, 320, 1e-5), (8192, 640, 1e-5),
      (2048, 1280, 1e-5)]
# (B, T, C, act) of GroupNorm (32 groups): the UNet's calls of a 512x512
# step (B = 2 denoising steps; the act of most calls at each shape), the
# DPT's (B = 1), then prepare's five largest (the 8 warmup frames in B)
GN = [
    (2, 4096, 320, "none"), (2, 4096, 640, "silu"), (2, 1024, 320, "silu"),
    (2, 1024, 640, "none"), (2, 1024, 960, "silu"), (2, 1024, 1280, "silu"),
    (2, 1024, 1920, "silu"), (2, 256, 640, "silu"), (2, 256, 1280, "none"),
    (2, 256, 1920, "silu"), (2, 256, 2560, "silu"), (2, 64, 1280, "silu"),
    (2, 64, 2560, "silu"), (1, 576, 256, "relu"), (1, 576, 1024, "none"),
    (1, 2304, 128, "relu"), (1, 2304, 256, "relu"), (1, 2304, 512, "none"),
    (1, 9216, 64, "relu"), (1, 9216, 128, "relu"), (1, 9216, 256, "none"),
    (1, 36864, 64, "relu"),
    (8, 4096, 640, "silu"), (8, 1024, 1920, "silu"), (8, 36864, 64, "relu"),
    (8, 9216, 256, "none"), (8, 4096, 320, "silu"),
]
# (B, H, W, Cin, stride, bias, skip and ReLU) of the fused conv: the encoder
# (B = 2) and decoder (B = 1) levels of the 512x512 and 768x512 steps,
# prepare's largest (B = 16 and 8), then the three downsamples of each
CONV = [
    *[(2, h, w, 3, 1, True, False) for h, w in ((512, 512), (512, 768))],
    *[(b, h, w, 64, 1, True, True) for b in (2, 1)
      for h, w in ((512, 512), (256, 256), (128, 128), (64, 64),
                   (512, 768), (256, 384), (128, 192), (64, 96))],
    (16, 512, 512, 3, 1, True, False), (16, 512, 512, 64, 1, True, True),
    (8, 512, 512, 64, 1, True, True),
    *[(2, h, w, 64, 2, False, False) for h, w in ((512, 512), (256, 256), (128, 128),
                                                  (512, 768), (256, 384), (128, 192))],
    (16, 512, 512, 64, 2, False, False),
]
# (N, Sq, Sk, H, D) of the fp32 training pair: a training step at 256x256,
# batch 2, clip 4 (chip_smoke.py phase 16): the spatial self- and
# cross-attentions at the four latent levels, the clip-mode temporal ones
TRAIN = [
    (8, 1024, 1024, 8, 40), (8, 256, 256, 8, 80), (8, 64, 64, 8, 160), (8, 16, 16, 8, 160),
    (8, 1024, 77, 8, 40), (8, 256, 77, 8, 80), (8, 64, 77, 8, 160), (8, 16, 77, 8, 160),
    (2048, 4, 4, 8, 40), (512, 4, 4, 8, 80), (128, 4, 4, 8, 160), (32, 4, 4, 8, 160),
]


def child(root: str, reps: int, only, device: bool) -> None:
    """Time every shape with the port found under ``root``; print JSON."""
    # this checkout may be on the path (PYTHONPATH, the working directory)
    sys.path = [root] + [p for p in sys.path if os.path.abspath(p or ".") != ROOT]
    import torch

    from live2diff_tpu_torch.ops import flash_attention as fa
    from live2diff_tpu_torch.ops import flash_train as ft
    from live2diff_tpu_torch.ops import stream_attention as sa
    from live2diff_tpu_torch.ops.conv import conv3x3
    from live2diff_tpu_torch.ops.norm import group_norm, layer_norm_rows

    time_ms = (device_timer if device else cold_timer)(torch, reps)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for cache in ("int8", "bf16") if only in (None, "stream") else ():
        for c, hw in STREAM:
            s, w, heads = 2, 16, 8
            q = torch.randn(s, hw, c, generator=gen, device="cuda").to(torch.bfloat16)
            extra = torch.randn(s, w, heads, hw, generator=gen, device="cuda")
            extra[:, 9:] = float("-inf")
            pe_v = torch.randn(s, w, c, generator=gen, device="cuda")
            scale = (c // heads) ** -0.5
            if cache == "int8":
                data = torch.randint(-127, 128, (s, 2, w, c, hw), generator=gen, device="cuda",
                                     dtype=torch.int8)
                scales = 0.002 + 0.02 * torch.rand(s, 2, w, c, generator=gen, device="cuda")
                fn = lambda: sa.stream_window_attention_int8(  # noqa: E731
                    q, data, scales, extra, pe_v, scale, heads)
            else:
                data = torch.randn(s, 2, w, c, hw, generator=gen, device="cuda").to(torch.bfloat16)
                fn = lambda: sa.stream_window_attention_bf16(  # noqa: E731
                    q, data, extra, pe_v, scale, heads)
            rows.append(dict(entry=f"stream {cache}", shape=f"q[{s},{hw},{c}]", ms=time_ms(fn)))
            del data
    for b, sq, sk, h, d in DMAJOR if only in (None, "flash") else ():
        q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(b, sk, h, d, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        rows.append(dict(entry="dmajor", shape=f"q[{b},{sq},{h},{d}] k[{b},{sk},{h},{d}]",
                         ms=time_ms(lambda: fa.flash_attention(q, k, v, d ** -0.5))))
    for b, s, d in SMAJOR if only in (None, "flash") else ():
        q, k, v = (torch.randn(b, s, 8, d, generator=gen, device="cuda").to(torch.bfloat16)
                   .transpose(1, 2) for _ in range(3))
        rows.append(dict(entry="smajor", shape=f"q[{b},8,{s},{d}] blocks (512, 1024)",
                         ms=time_ms(lambda: fa.flash_self_attention(q, k, v, d ** -0.5, 512,
                                                                     1024))))
    for b, s, d in INT8 if only in (None, "int8") else ():
        q, k, v = (torch.randn(b, s, 8, d, generator=gen, device="cuda").to(torch.bfloat16)
                   .transpose(1, 2) for _ in range(3))
        bk = min(s, 4096)
        rows.append(dict(entry="int8", shape=f"q[{b},8,{s},{d}] blocks (512, {bk})",
                         ms=time_ms(lambda: fa.flash_self_attention_int8(q, k, v, d ** -0.5,
                                                                          512, bk))))
    for n, c, eps in LN if only in (None, "ln") else ():
        x = (torch.randn(n, c, generator=gen, device="cuda") * 2.0 + 0.5).to(torch.bfloat16)
        g = (1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
        bt = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
        rows.append(dict(entry="layer_norm", shape=f"x[{n},{c}] eps {eps:g}",
                         ms=time_ms(lambda: layer_norm_rows(x, g, bt, eps))))
    for b, t, c, act in GN if only in (None, "gn") else ():
        x = (torch.randn(b, t, c, generator=gen, device="cuda") * 3.0 + 2.0).to(torch.bfloat16)
        g = (1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
        bt = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
        rows.append(dict(entry="group_norm", shape=f"x[{b},{t},{c}] G32 {act}",
                         ms=time_ms(lambda: group_norm(x, g, bt, 32, 1e-5, act))))
        del x
    for b, h, w, cin, stride, bias, fused in CONV if only in (None, "conv") else ():
        x = torch.randn(b, h, w, cin, generator=gen, device="cuda").to(torch.bfloat16)
        wt = (torch.randn(64, cin, 3, 3, generator=gen, device="cuda") / (9 * cin) ** 0.5
              ).to(torch.bfloat16)
        bs = torch.randn(64, generator=gen, device="cuda").to(torch.bfloat16) if bias else None
        sk = (torch.randn(b, h // stride, w // stride, 64, generator=gen, device="cuda")
              .to(torch.bfloat16) if fused else None)
        rows.append(dict(entry=f"conv s{stride}",
                         shape=f"x[{b},{h},{w},{cin}]" + (" +skip+relu" if fused else ""),
                         ms=time_ms(lambda: conv3x3(x, wt, bs, sk, fused, stride))))
        del x, sk
    for n, sq, sk, h, d in TRAIN if only in (None, "train") else ():
        q, do = (torch.randn(n, sq, h, d, generator=gen, device="cuda") for _ in range(2))
        k, v = (torch.randn(n, sk, h, d, generator=gen, device="cuda") for _ in range(2))
        out, lse = ft.flash_train_fwd(q, k, v, d ** -0.5)
        shape = f"q[{n},{sq},{h},{d}] k[{n},{sk},{h},{d}]"
        rows.append(dict(entry="train fwd", shape=shape,
                         ms=time_ms(lambda: ft.flash_train_fwd(q, k, v, d ** -0.5))))
        rows.append(dict(entry="train bwd", shape=shape, ms=time_ms(
            lambda: ft.flash_train_bwd(q, k, v, out, lse, do, d ** -0.5))))
        del q, k, v, do, out, lse
    print(json.dumps(dict(port=os.path.dirname(fa.__file__), rows=rows)))


def run_child(root: str, reps: int, only, device: bool):
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root,
                          "--reps", str(reps)] + (["--only", only] if only else [])
                         + (["--device"] if device else []),
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"timing {root} failed:\n{out.stdout}\n{out.stderr}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    if not res["port"].startswith(root + os.sep):
        raise RuntimeError(f"timing {root} imported the port from {res['port']}")
    return res["rows"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout of the repository, timed in turns")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", help="also write the rows to this file")
    ap.add_argument("--only", choices=("stream", "flash", "conv", "int8", "ln", "gn", "train"))
    ap.add_argument("--device", action="store_true",
                    help="the kernels' device time by the profiler, not events")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.reps, args.only, args.device)
        return 0
    smi = card()
    print(smi)
    other = os.path.abspath(args.other) if args.other else None
    order = [ROOT] if not other else [ROOT, other, other, ROOT]
    runs = [(root, run_child(root, args.reps, args.only, args.device)) for root in order]
    table = []
    for i, row in enumerate(runs[0][1]):
        this = [r[i]["ms"] for root, r in runs if root == ROOT]
        entry = dict(entry=row["entry"], shape=row["shape"], ms=sum(this) / len(this),
                     ms_turns=this)
        if other:
            that = [r[i]["ms"] for root, r in runs if root != ROOT]
            entry.update(other_ms=sum(that) / len(that), other_ms_turns=that)
        table.append(entry)
        print(json.dumps(entry))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(device=smi, rows=table), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
