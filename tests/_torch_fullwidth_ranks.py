"""One rank of ``tests/_torch_fullwidth.py``'s item 6 (imports no JAX).

Reads ``args.json`` from ``out_dir`` (``tiny``, ``tol``) and writes
``rank<r>.json``: the tp 2 step's reading against the unsharded one. At full
width that is ``flagship_stream_tp_check`` (``UNetConfig()``, an 8x8 latent,
fp32, random N(0, 0.02^2) weights as in the JAX check); at ``tiny`` the same
check of the tp dryrun's UNet."""

from __future__ import annotations

import json
import os


def ranked(rank: int, out_dir: str) -> None:
    from live2diff_tpu_torch.models.unet import UNetConfig
    from live2diff_tpu_torch.parallel.infer import (
        DRYRUN_UNET, flagship_stream_tp_check, tp_stream_check,
    )
    from live2diff_tpu_torch.parallel.mesh import make_mesh

    with open(os.path.join(out_dir, "args.json")) as f:
        args = json.load(f)
    mesh = make_mesh(tp=2)
    if args["tiny"]:
        report = tp_stream_check(mesh, UNetConfig(**DRYRUN_UNET), device="cpu")
        reading = {"rel_rms": report["rel_rms"][0], "max_rel": report["max_rel_err"][0]}
        notes = {"param_bytes_on_tp": report["param_bytes_on_tp"]}
    else:
        # asserts the bound and >= 60 % of the parameter bytes on tp; its
        # reading is the largest error over the largest value only
        reading = {"rel_rms": None,
                   "max_rel": flagship_stream_tp_check(mesh, tol=args["tol"], device="cpu")}
        notes = {"config": "UNetConfig()"}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"reading": reading, "notes": notes}, f)
