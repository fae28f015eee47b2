"""The ranked half of tests/test_torch_parallel_infer.py: what each of two
gloo ranks computes through ``parallel/infer.py`` and ``train_step_dryrun``
(imports no JAX; the test reads ``rank<r>.pt``)."""

from __future__ import annotations

import os

import torch

from live2diff_tpu_torch.models.unet import UNetConfig
from live2diff_tpu_torch.parallel import infer
from live2diff_tpu_torch.parallel.mesh import make_mesh
from live2diff_tpu_torch.parallel.train import train_step_dryrun

SESSIONS = 4


def ranked(rank: int, out_dir: str) -> None:
    tp = make_mesh()
    dp = make_mesh(tp=1)
    assert (tp.dp, tp.tp, dp.dp, dp.tp, dp.dp_rank) == (1, 2, 2, 1, rank)
    config = UNetConfig(**infer.DRYRUN_UNET)
    res = {
        "stream_dryrun": infer.stream_step_tp_dryrun(tp, device="cpu"),
        "train_tp": train_step_dryrun(tp, device="cpu"),
        "train_dp": train_step_dryrun(dp, device="cpu"),
        "check_fp32": infer.tp_stream_check(tp, config, frames=4, text_len=7, device="cpu"),
        "check_int8": infer.tp_stream_check(tp, config, frames=4, text_len=7, device="cpu",
                                            cache_dtype=torch.int8),
        "sessions": infer.multi_session_run(dp, SESSIONS, device="cpu"),
        "sessions_dryrun": infer.multi_session_dp_dryrun(dp, device="cpu"),
    }
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
