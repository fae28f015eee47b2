"""The warm start on the card (``aot.py``, ``StreamV2VWrapper(engine_dir=)``,
``prime_aot``), at a tiny width.

A 64x64 pipeline (a narrow UNet, no depth model, int8 KV cache, bf16) is
primed into a temporary engine directory; a second wrapper of the same
configuration loads its libraries from there (``aot_hit``) and its first
frame equals the first wrapper's bit for bit; a copy of the directory with
one flipped byte in a library is refused and left on disk. These need an
NVIDIA Hopper GPU and ``nvcc``; without a CUDA device each test skips. Run
them on the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_aot_cuda.py

``chip_smoke.py``'s phase 17 does the same at full width in fresh
processes, and shows that a warm process runs no ``nvcc``.
"""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

from live2diff_tpu_torch import aot
from live2diff_tpu_torch.ops import _build
from live2diff_tpu_torch.wrapper import WARMUP_FRAMES, StreamV2VWrapper

pytestmark = pytest.mark.cuda

SIZE = 64
NARROW = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=2, norm_num_groups=8,
              motion_num_attention_heads=2)
CONFIG = {"num_inference_steps": 50, "t_index_list": [30, 40],
          "unet_additional_kwargs": {"motion_module_kwargs": {
              "num_attention_heads": 2,
              "attention_kwargs": {"window_size": 16, "sink_size": 8}}}}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _wrapper(dev, engine_dir):
    return StreamV2VWrapper(CONFIG, height=SIZE, width=SIZE, use_depth=False,
                            use_text_encoder=False, output_type="np", kv_cache_dtype="int8",
                            unet_overrides=NARROW, device=dev, seed=3,
                            engine_dir=str(engine_dir))


def _first_frame(wrapper):
    rng = np.random.RandomState(0)
    wrapper.prepare("a cat", rng.randint(0, 256, (WARMUP_FRAMES, SIZE, SIZE, 3)).astype(np.uint8))
    return wrapper(rng.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8))


def test_a_primed_dir_warm_starts_bit_equal_and_a_tampered_one_is_kept(dev, tmp_path):
    engines = tmp_path / "engines"
    cold = _wrapper(dev, engines)
    assert cold.aot_hit is False
    cold_frame = _first_frame(cold)
    assert cold.prime_aot()
    key = aot.engine_key(dev)
    path = engines / "aot" / key
    manifest = json.loads((path / aot.MANIFEST).read_text())
    # every library loaded in this process, the tiny pipeline's among them
    assert set(manifest["files"]) == set(_build.loaded())
    assert {"stream_attention", "flash_attention", "conv3x3"} <= set(manifest["files"])

    warm = _wrapper(dev, engines)
    assert warm.aot_hit is True and warm.stream._aot_load_s > 0
    for source, entry in manifest["files"].items():
        assert _build._LIBS[source]._name == str(path / entry["file"])
    np.testing.assert_array_equal(_first_frame(warm), cold_frame)

    tampered = tmp_path / "tampered"
    shutil.copytree(engines, tampered)
    lib = tampered / "aot" / key / manifest["files"]["flash_attention"]["file"]
    data = bytearray(lib.read_bytes())
    data[len(data) // 2] ^= 0x01
    lib.write_bytes(bytes(data))
    libs = dict(_build._LIBS)
    assert aot.load_engines(warm.stream, str(tampered)) is False
    assert lib.read_bytes() == bytes(data)
    assert sorted(p.name for p in (tampered / "aot" / key).iterdir()) == sorted(
        p.name for p in path.iterdir())
    assert _build._LIBS == libs
