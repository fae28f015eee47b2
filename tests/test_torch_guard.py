"""Boundaries of the port: no JAX inside it, the card by default, and kernel
wrappers that take their plain versions only for CPU tensors."""

from __future__ import annotations

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import live2diff_tpu_torch
from live2diff_tpu_torch.ops import _build
from live2diff_tpu_torch.ops.conv import conv3x3, conv3x3_plain
from live2diff_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from live2diff_tpu_torch.ops.norm import layer_norm, layer_norm_plain
from live2diff_tpu_torch.ops.stream_attention import (
    stream_window_attention_bf16, stream_window_attention_int8, stream_window_attention_plain,
)

PKG_DIR = os.path.dirname(live2diff_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|live2diff_tpu)\b(?!_torch)", re.M)


def _port_sources():
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_importing_the_port_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys, live2diff_tpu_torch\n"
        "for m in pkgutil.walk_packages(live2diff_tpu_torch.__path__, 'live2diff_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'live2diff_tpu')]\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_import_no_jax():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            for m in _FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}")
    assert not offenders, offenders


def test_build_pipeline_refuses_to_fall_back_to_the_cpu(monkeypatch):
    from live2diff_tpu_torch.builder import build_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_pipeline({"t_index_list": [30, 40]})


def test_build_pipeline_depth_raises_with_the_roadmap_item():
    """Depth is ported; the full KL codec is not, and says where it stands."""
    from live2diff_tpu_torch.builder import build_pipeline

    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 7"):
        build_pipeline({"t_index_list": [30, 40]}, use_tiny_vae=False, device="cpu")


def test_wrappers_run_the_plain_version_on_cpu_tensors(monkeypatch):
    def no_build(name):
        raise AssertionError(f"a CPU tensor must not build or launch {name}")

    monkeypatch.setattr(_build, "load", no_build)
    before = dict(_build.launch_counts)
    rs = np.random.RandomState(0)
    t = lambda *shape: torch.from_numpy(rs.randn(*shape).astype(np.float32))  # noqa: E731

    q, k, v = t(2, 40, 2, 8), t(2, 77, 2, 8), t(2, 77, 2, 8)
    torch.testing.assert_close(flash_attention(q, k, v, 0.3), flash_attention_plain(q, k, v, 0.3))

    x, w, b, skip = t(1, 12, 10, 8), t(64, 8, 3, 3), t(64), t(1, 12, 10, 64)
    torch.testing.assert_close(conv3x3(x, w, b, skip, True), conv3x3_plain(x, w, b, skip, True))
    torch.testing.assert_close(conv3x3(x, w, stride=2), conv3x3_plain(x, w, stride=2))

    data = torch.from_numpy(rs.randint(-127, 128, (2, 2, 16, 16, 8)).astype(np.int8))
    args = (t(2, 8, 16), data, t(2, 2, 16, 16).abs(), t(2, 16, 2, 8), t(2, 16, 16), 0.25, 2)
    torch.testing.assert_close(stream_window_attention_int8(*args),
                               stream_window_attention_plain(*args))
    cache = t(2, 2, 16, 16, 8).to(torch.bfloat16)
    args = (t(2, 8, 16), cache, t(2, 16, 2, 8), t(2, 16, 16), 0.25, 2)
    torch.testing.assert_close(stream_window_attention_bf16(*args),
                               stream_window_attention_plain(args[0], cache, None, *args[2:]))

    x, g, b = t(37, 64), t(64), t(64)
    torch.testing.assert_close(layer_norm(x, g, b, 1e-6, site="vit"),
                               layer_norm_plain(x, g, b, 1e-6))
    assert _build.launch_counts == before


def test_build_pipeline_on_cpu_streams_uint8_frames():
    """build_pipeline's whole path at a tiny UNet width: int8 cache, uint8 out."""
    from live2diff_tpu_torch.builder import build_pipeline

    tiny = dict(block_out_channels=(8, 16, 16, 16), attention_head_dim=2,
                cross_attention_dim=12, norm_num_groups=4, motion_num_attention_heads=2)
    config = {
        "num_inference_steps": 50, "t_index_list": [30, 40],
        "unet_additional_kwargs": {"motion_module_kwargs": {
            "num_attention_heads": 2, "attention_kwargs": {"window_size": 16, "sink_size": 8},
        }},
    }
    built = build_pipeline(config, 64, 64, dtype=torch.float32, kv_cache_dtype="int8",
                           output_uint8=True, seed=0, device="cpu", unet_overrides=tiny,
                           use_depth=False)
    assert built.stream.cfg.cache_dtype == torch.int8
    warm = torch.rand(8, 64, 64, 3) * 2 - 1
    state, warm_out = built.stream.prepare(warm, torch.randn(1, 7, 12), seed=3)
    assert warm_out.dtype == torch.uint8 and warm_out.shape == (8, 64, 64, 3)
    for i in range(3):
        frame = torch.randint(0, 256, (64, 64, 3), dtype=torch.uint8)
        state, out = built.stream(state, frame)
        assert out.dtype == torch.uint8 and out.shape == (64, 64, 3)
    assert state.frame_idx == 3
