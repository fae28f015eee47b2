"""Tensor parallelism on the card: two gloo ranks share one card, CUDA
tensors in their all-reduces (NCCL refuses two ranks on one device).

* The dryruns' tiny UNet (every head 8 wide) streams at tp = 2 in bf16 with
  an int8 cache (the warmup, then 3 frames), launching the stream-attention
  and flash kernels at H/2 heads, within 0.10 relative RMS of the same
  weights unsharded in fp32 on the CPU (bf16 against fp32: chip_smoke.py's
  small-input bound).
* ``train_step_dryrun`` at tp = 2 (fp32, TF32 off) within 1e-5 of one
  process on the card.

These need an NVIDIA Hopper GPU and ``nvcc``; without a CUDA device each
test skips. On the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_parallel_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from _torch_ranks import spawn
from live2diff_tpu_torch.models.unet import UNetConfig
from live2diff_tpu_torch.parallel.infer import (
    DRYRUN_UNET, random_unet, run_stream, stream_inputs,
)
from live2diff_tpu_torch.parallel.mesh import Mesh
from live2diff_tpu_torch.parallel.train import train_step_dryrun

pytestmark = pytest.mark.cuda

CPU_TOL, LOSS_TOL = 0.10, 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = tmp_path_factory.mktemp("tp_cuda")
    config = UNetConfig(**DRYRUN_UNET)
    unet = random_unet(config, 0, torch.float32, "cpu")
    inputs = stream_inputs(config, 8, 2, 3, 7, 1, torch.float32, "cpu")
    ref, _, _ = run_stream(unet, config.init_caches(8, 8, 2, torch.float32, "cpu"), inputs)
    torch.save({"sd": unet.state_dict(), "inputs": inputs}, out / "inputs.pt")
    spawn("_torch_parallel_cuda_ranks", 2, str(out))
    return ref, [torch.load(out / f"rank{r}.pt", weights_only=True) for r in range(2)]


def test_tp2_stream_on_the_card_matches_the_cpu(ranks):
    ref, results = ranks
    for res in results:
        for out, r in zip(res["outs"], ref):
            err = float(((out - r) ** 2).mean().sqrt() / (r ** 2).mean().sqrt())
            assert err <= CPU_TOL, err
        for frame in res["launches"]:
            assert frame.get("stream_attention_int8") and frame.get("flash_attention"), frame


def test_tp2_train_step_on_the_card_matches_one_process(ranks):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loss = train_step_dryrun(Mesh(), device="cuda")
    for res in ranks[1]:
        assert abs(res["loss"] - loss) <= LOSS_TOL * abs(loss), (res["loss"], loss)
