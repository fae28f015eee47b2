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


def test_importing_the_port_pulls_in_no_optional_host_package():
    """safetensors, Pillow and imageio are optional on the card's host: the
    port reads .safetensors itself and imports Pillow and imageio only in
    the calls that need them."""
    code = (
        "import importlib, pkgutil, sys, live2diff_tpu_torch\n"
        "for m in pkgutil.walk_packages(live2diff_tpu_torch.__path__, 'live2diff_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('safetensors', 'PIL', 'imageio')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    offenders = [path for path in _port_sources()
                 if re.search(r"^\s*(import|from)\s+safetensors\b", open(path).read(), re.M)]
    assert not offenders, offenders


def test_the_scan_covers_the_bench_and_kernel_check():
    scanned = {os.path.relpath(path, REPO) for path in _port_sources()}
    assert {"live2diff_tpu_torch/bench.py", "live2diff_tpu_torch/tools/kernel_check.py",
            "chip_smoke.py"} <= scanned


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


def test_build_pipeline_builds_the_kl_codec_on_cpu():
    """use_tiny_vae=False builds SD-1.5's AutoencoderKL at its own widths,
    its parameters drawn as N(0, 0.02^2) (no file names them), with the KL
    latent scaling."""
    from live2diff_tpu_torch.builder import build_pipeline
    from live2diff_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    tiny = dict(block_out_channels=(8, 16, 16, 16), attention_head_dim=2,
                norm_num_groups=4, motion_num_attention_heads=2)
    built = build_pipeline({"t_index_list": [30, 40]}, use_tiny_vae=False, device="cpu",
                           use_depth=False, unet_overrides=tiny)
    assert isinstance(built.vae, AutoencoderKL) and built.stream.vae is built.vae
    assert built.vae.config == VAEConfig()
    assert built.stream.cfg.vae_scaling == 0.18215
    w = built.vae.decoder.up_blocks[3].resnets[2].conv2.weight.float()
    assert abs(float(w.std()) - 0.02) < 1e-3
    assert all(p.device.type == "cpu" and p.dtype == torch.bfloat16
               for p in built.vae.parameters())


def test_port_sources_import_nothing_of_the_demo():
    """The demo server's protocol code is the port's own copy."""
    pattern = re.compile(r"^\s*(import|from)\s+(demo|server)\b|sys\.path.*demo", re.M)
    offenders = [path for path in _port_sources() if pattern.search(open(path).read())]
    assert not offenders, offenders


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


def test_importing_the_training_modules_pulls_in_no_jax():
    """The trainer and its parallel package, imported alone (not through
    the package walk), leave JAX out, and the trainer's entry defaults to
    the card."""
    code = (
        "import sys, inspect\n"
        "import live2diff_tpu_torch.train as t\n"
        "import live2diff_tpu_torch.parallel.train, live2diff_tpu_torch.parallel.mesh\n"
        "import live2diff_tpu_torch.parallel.data, live2diff_tpu_torch.parallel.checkpoint\n"
        "import live2diff_tpu_torch.ops.flash_train\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',"
        " 'orbax', 'live2diff_tpu')]\n"
        "assert not bad, bad\n"
        "assert inspect.signature(t.Trainer).parameters['device'].default is None\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_importing_the_parallel_modules_pulls_in_no_jax():
    """Tensor parallelism and the multi-rank inference, imported alone,
    leave JAX out; their entry points default to the card."""
    code = (
        "import sys, inspect\n"
        "import live2diff_tpu_torch.parallel.tp as tp, live2diff_tpu_torch.parallel.infer as i\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',"
        " 'orbax', 'live2diff_tpu')]\n"
        "assert not bad, bad\n"
        "for f in (i.stream_step_tp_dryrun, i.flagship_stream_tp_check, i.tp_stream_check,\n"
        "          i.multi_session_dp_dryrun, i.dryrun_multichip):\n"
        "    assert inspect.signature(f).parameters['device'].default is None, f\n"
        "assert callable(tp.shard_params) and callable(i.cache_sharding)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_training_kernels_take_their_plain_versions_on_cpu_tensors(monkeypatch):
    from live2diff_tpu_torch.ops.flash_train import (
        flash_train_bwd, flash_train_bwd_plain, flash_train_fwd, flash_train_fwd_plain,
    )

    def no_build(name):
        raise AssertionError(f"a CPU tensor must not build or launch {name}")

    monkeypatch.setattr(_build, "load", no_build)
    before = dict(_build.launch_counts)
    rs = np.random.RandomState(1)
    q, k, v, do = (torch.from_numpy(rs.randn(2, n, 2, 8).astype(np.float32))
                   for n in (5, 77, 77, 5))
    out, lse = flash_train_fwd(q, k, v, 0.3)
    ref_out, ref_lse = flash_train_fwd_plain(q, k, v, 0.3)
    torch.testing.assert_close(out, ref_out)
    torch.testing.assert_close(lse, ref_lse)
    for got, want in zip(flash_train_bwd(q, k, v, out, lse, do, 0.3),
                         flash_train_bwd_plain(q, k, v, out, lse, do, 0.3)):
        torch.testing.assert_close(got, want)
    assert _build.launch_counts == before
    assert "flash_train" in _build.SOURCES
    assert {"flash_train_fwd", "flash_train_bwd"} <= set(_build.launch_counts)


def test_importing_the_warm_start_and_the_tools_pulls_in_no_jax_and_no_plotting():
    """aot.py, utils/timing.py, utils/attn_vis.py and every tool, each
    imported alone: no JAX, no package of the JAX side, and no matplotlib,
    Pillow or imageio (the card's host has no matplotlib and no imageio)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import live2diff_tpu_torch.tools as tools\n"
        "names = ['live2diff_tpu_torch.aot', 'live2diff_tpu_torch.utils.timing',\n"
        "         'live2diff_tpu_torch.utils.attn_vis']\n"
        "names += [m.name for m in pkgutil.iter_modules(tools.__path__, tools.__name__ + '.')]\n"
        "assert {'live2diff_tpu_torch.tools.' + n for n in ('psnr', 'parity', 'profile_stages',"
        " 'trace_step', 'aot_probe')} <= set(names), names\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax',"
        " 'live2diff_tpu', 'matplotlib', 'PIL', 'imageio')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
