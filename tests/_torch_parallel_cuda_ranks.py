"""The ranked half of tests/test_torch_parallel_cuda.py: two gloo ranks on
one card, CUDA tensors in the collectives (imports no JAX)."""

from __future__ import annotations

import os

import torch

from live2diff_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from live2diff_tpu_torch.parallel.infer import DRYRUN_UNET, run_stream
from live2diff_tpu_torch.parallel.mesh import make_mesh
from live2diff_tpu_torch.parallel.tp import shard_params
from live2diff_tpu_torch.parallel.train import train_step_dryrun


def ranked(rank: int, out_dir: str) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=True)
    mesh = make_mesh()
    dev = torch.device("cuda")
    config = UNetConfig(**DRYRUN_UNET)
    unet = UNet3DConditionModel(config)
    unet.load_state_dict(data["sd"])
    unet = unet.to(dev, torch.bfloat16).eval()
    shard_params(unet, mesh)
    inputs = {k: v.to(dev, torch.bfloat16 if v.is_floating_point() else v.dtype)
              for k, v in data["inputs"].items()}
    caches = config.init_caches(8, 8, 2, torch.int8, dev, tp=mesh.tp)
    outs, _, run = run_stream(unet, caches, inputs)
    torch.save({"outs": [o.float().cpu() for o in outs], "launches": run["launches"],
                "loss": train_step_dryrun(mesh, device=dev)},
               os.path.join(out_dir, f"rank{rank}.pt"))
