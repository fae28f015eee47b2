"""The port's own copies of the config loader, the LCM schedule and the UNet
config against the JAX package's: the same YAML gives the same dict, the
same schedule tables and the same cache geometry."""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from live2diff_tpu.config import load_config as jax_load_config
from live2diff_tpu.models.unet import UNetConfig as JaxUNetConfig
from live2diff_tpu.schedule import LCMSchedule as JaxLCMSchedule
from live2diff_tpu_torch.builder import build_pipeline
from live2diff_tpu_torch.config import load_config
from live2diff_tpu_torch.models.unet import UNetConfig
from live2diff_tpu_torch.schedule import LCMSchedule

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_and_unet_config_match_jax(path):
    cfg = load_config(path)
    assert cfg.to_dict() == jax_load_config(path).to_dict()
    ours = dataclasses.asdict(UNetConfig.from_reference_config(cfg.to_dict()))
    ref = dataclasses.asdict(JaxUNetConfig.from_reference_config(cfg.to_dict()))
    assert {k: ref[k] for k in ours} == ours


@pytest.mark.parametrize("kwargs", [
    dict(num_inference_steps=50, t_index_list=[30, 40]),
    dict(num_inference_steps=50, t_index_list=[25, 31, 37, 43]),
    dict(num_inference_steps=4, strength=0.5),
    dict(num_inference_steps=50, t_index_list=[10, 20, 30], beta_schedule="scaled_linear"),
])
def test_lcm_schedule_matches_jax(kwargs):
    ours, ref = LCMSchedule.create(**kwargs), JaxLCMSchedule.create(**kwargs)
    for field in ("sub_timesteps", "c_skip", "c_out", "alpha_prod_sqrt", "beta_prod_sqrt"):
        np.testing.assert_array_equal(getattr(ours, field), np.asarray(getattr(ref, field)))
    assert ours.t_index_list == tuple(ref.t_index_list)


@pytest.mark.parametrize("latent_hw", [(64, 64), (96, 64), (9, 13)])
def test_cache_shapes_match_jax(latent_hw):
    """Ceil-halving per level: the odd (9, 13) latent gives 5x7, 3x4, 2x2."""
    ours = UNetConfig().cache_shapes(*latent_hw, 2)
    assert ours == JaxUNetConfig().cache_shapes(*latent_hw, 2)
    assert len(ours) == UNetConfig().num_caches() == 40


def test_build_pipeline_from_a_reference_yaml():
    """A style YAML with a ``base:`` file builds the port's pipeline: the
    4-step schedule of toonyou.yaml and 40 caches at the served width."""
    path = [p for p in CONFIGS if p.endswith("toonyou.yaml")][0]
    tiny = dict(block_out_channels=(8, 16, 16, 16), attention_head_dim=2,
                cross_attention_dim=12, norm_num_groups=4)
    built = build_pipeline(path, 64, 64, dtype=torch.float32, kv_cache_dtype="int8",
                           device="cpu", unet_overrides=tiny)
    ref = JaxLCMSchedule.create(50, t_index_list=[25, 31, 37, 43])
    np.testing.assert_array_equal(built.schedule.sub_timesteps, np.asarray(ref.sub_timesteps))
    state = built.stream.init_state()
    assert len(state.kv_caches) == 40
    assert state.kv_caches[0][0].shape == (4, 2, 16, 8, 64)
    # TAESD takes and gives scaled latents: the builder sets no scaling
    assert built.stream.cfg.vae_scaling == 1.0


def test_stream_config_defaults_match_jax():
    """The port's StreamConfig() defaults are the JAX StreamConfig()'s,
    vae_scaling (SD-1.5's 0.18215, for an AutoencoderKL) included."""
    from live2diff_tpu.stream.pipeline import StreamConfig as JaxStreamConfig
    from live2diff_tpu_torch.stream.pipeline import StreamConfig

    ours, theirs = StreamConfig(), JaxStreamConfig()
    assert ours.vae_scaling == theirs.vae_scaling == 0.18215
    for f in ("height", "width", "do_add_noise", "vae_scale_factor", "output_uint8"):
        assert getattr(ours, f) == getattr(theirs, f), f
