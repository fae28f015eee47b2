#!/usr/bin/env python3
"""Where the tp = 2 bf16 stream step departs from the unsharded one, on one card.

    python3 scripts/tp_probe.py [--weights flagship|fan_in] [--frames N]

Two gloo ranks share the card, as in ``chip_smoke.py`` phase 18. Each rank:

1. every kind of tp block of the full-width UNet alone, at the 64x64
   latent's width (``CrossAttention`` with 8 heads of 40, a
   ``TemporalAttention`` in clip mode, a GEGLU feed-forward, a
   ``ResnetBlock3D`` 320 -> 320; matrices N(0, 1/fan_in), norm scales 1,
   biases 0), bf16, cut over tp against itself unsharded: the relative RMS
   and the share of output elements that differ;
2. ``parallel/infer.py:tp_stream_check`` of ``UNetConfig()`` at 512x512, 2
   steps, bf16, int8 cache: each frame's relative RMS, the cache slabs;
3. on rank 0, the control: the unsharded step against itself with 1 % of
   its warmup latents moved by 2^-7 of their value.

``--weights flagship`` (the default) draws every parameter N(0, 0.02^2), as
``random_unet`` does; ``fan_in`` draws every matrix N(0, 1/fan_in), norm
scales 1 and biases 0. Prints one JSON line a rank, tagged ``TP_PROBE``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NUDGE_SHARE, NUDGE = 0.01, 2.0 ** -7


def fan_in_(module, gen):
    import torch

    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * p[0].numel() ** -0.5)
            else:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
    return module


def rank_main(rank: int, port: int, weights: str, frames: int) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    from live2diff_tpu_torch.models.attention import CrossAttention
    from live2diff_tpu_torch.models.layers import GEGLUFeedForward
    from live2diff_tpu_torch.models.motion import TemporalAttention
    from live2diff_tpu_torch.models.resnet import ResnetBlock3D
    from live2diff_tpu_torch.models.unet import UNetConfig
    from live2diff_tpu_torch.parallel import infer
    from live2diff_tpu_torch.parallel.mesh import make_mesh
    from live2diff_tpu_torch.parallel.tp import shard_params

    dev = torch.device("cuda")
    mesh = make_mesh()
    if weights == "fan_in":
        draw = infer.random_unet
        infer.random_unet = lambda config, seed=0, dtype=torch.float32, device=None: fan_in_(
            draw(config, seed, torch.float32, device),
            torch.Generator(device=device).manual_seed(seed)).to(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, 4096, 320, generator=gen, device=dev).bfloat16()
    temb = torch.randn(2, 1280, generator=gen, device=dev).bfloat16()
    blocks = {
        "attention": (CrossAttention(320, 8, 40), lambda m: m(x)),
        "temporal": (TemporalAttention(320, 8), lambda m: m(x.reshape(1, 4096, 2, 320), None,
                                                           "clip")[0]),
        "feed_forward": (GEGLUFeedForward(320), lambda m: m(x)),
        "resnet": (ResnetBlock3D(320, 320, 1280),
                   lambda m: m(x.reshape(2, 1, 64, 64, 320), temb)),
    }
    out = {"weights": weights}
    with torch.no_grad():
        for name, (module, call) in blocks.items():
            module = fan_in_(module.to(dev), torch.Generator(device=dev).manual_seed(1))
            module = module.bfloat16().eval()
            ref = call(module)
            cut = copy.deepcopy(module)
            shard_params(cut, mesh)
            got = call(cut)
            out[name] = {"rel_rms": infer._rel_rms(got, ref),
                         "elements_differ": float((got != ref).float().mean())}
    config = UNetConfig()
    report = infer.tp_stream_check(mesh, config, latent=64, steps=2, frames=frames, device=dev)
    out["stream"] = {k: report[k] for k in ("rel_rms", "caches", "param_bytes_on_tp")}
    if rank == 0:
        unet = infer.random_unet(config, 0, torch.bfloat16, dev)
        inputs = infer.stream_inputs(config, 64, 2, frames, 77, 1, torch.bfloat16, dev)
        runs = []
        for nudge in (False, True):
            ins = dict(inputs)
            if nudge:
                g = torch.Generator(device=dev).manual_seed(3)
                pick = torch.rand(ins["warm_sample"].shape, generator=g, device=dev) < NUDGE_SHARE
                ins["warm_sample"] = torch.where(pick, ins["warm_sample"] * (1 + NUDGE),
                                                 ins["warm_sample"])
            caches = config.init_caches(64, 64, 2, torch.int8, dev)
            runs.append(infer.run_stream(unet, caches, ins)[:2])
        (ref, ref_caches), (got, caches) = runs
        out["control"] = {"rel_rms": [infer._rel_rms(g, r) for g, r in zip(got, ref)],
                          "caches": infer.compare_caches(caches, ref_caches)}
    print("TP_PROBE " + json.dumps(out), flush=True)
    dist.destroy_process_group()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--weights", choices=("flagship", "fan_in"), default="flagship")
    p.add_argument("--frames", type=int, default=3)
    a = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tp_probe: needs a CUDA device", file=sys.stderr)
        return 2
    from probe_util import card
    from live2diff_tpu_torch.ops import _build

    print(card())
    _build.build(_build.SOURCES)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                               str(port), a.weights, str(a.frames)]) for r in range(2)]
    return max(proc.wait(timeout=900) for proc in procs)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], int(sys.argv[5]))
        sys.exit(0)
    sys.exit(main())
