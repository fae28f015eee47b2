"""Shared set-up of the port-vs-JAX parity tests (tests/test_torch_*.py).

Both sides get the same weights: the JAX parameter tree is drawn with numpy
from a seed over ``jax.eval_shape`` of the module's init (seconds, where a
real ``init`` of the tiny UNet takes a minute on one CPU core), and the
port loads it through ``params_from_jax``. Every parameter is random,
including the zero-initialised output projections of the motion modules
and the depth-mapping branch, so no path is a no-op.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from live2diff_tpu.models.unet import UNet3DConditionModel as JaxUNet
from live2diff_tpu.models.unet import UNetConfig as JaxUNetConfig
from live2diff_tpu.models.vae import TinyAutoencoder as JaxTinyAutoencoder
from live2diff_tpu.stream.state_machine import init_window_state, mask_to_bias
from live2diff_tpu_torch.convert.from_jax import params_from_jax

# the tiny configuration of tests/conftest.py's tiny_pipeline fixture
TINY_UNET = dict(
    block_out_channels=(8, 16, 16, 16), attention_head_dim=2,
    cross_attention_dim=12, norm_num_groups=4, motion_num_attention_heads=2,
)
TINY_H = TINY_W = 64  # latent 8x8
PROMPT_LEN = 7
VAE_HIDDEN = 8

torch.set_num_threads(2)


def random_params_like(shapes, seed: int):
    """Numpy-drawn parameters for an ``eval_shape`` tree: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), biases N(0, 0.05^2)."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            arr = rs.randn(*shape) / np.sqrt(fan_in)
        elif name == "scale":
            arr = 1.0 + 0.1 * rs.randn(*shape)
        else:
            arr = 0.05 * rs.randn(*shape)
        return jnp.asarray(arr.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_unet(seed: int = 0, num_steps: int = 2):
    """(flax module, params) of the tiny fp32 UNet."""
    cfg = JaxUNetConfig(**TINY_UNET)
    unet = JaxUNet(config=cfg, dtype=jnp.float32)
    lh, lw = TINY_H // 8, TINY_W // 8
    caches = cfg.init_caches(lh, lw, num_steps, dtype=jnp.float32)
    mask, pe_idx, update_idx = init_window_state(num_steps)
    z = jnp.zeros((num_steps, 1, lh, lw, 4))
    shapes = jax.eval_shape(lambda: unet.init(
        jax.random.PRNGKey(0), z, jnp.zeros((num_steps,), jnp.int32),
        jnp.zeros((num_steps, PROMPT_LEN, 12)), z, caches, "stream",
        mask_to_bias(mask), pe_idx, update_idx,
    ))
    return unet, random_params_like(shapes, seed)


def jax_taesd(seed: int = 1):
    vae = JaxTinyAutoencoder(hidden=VAE_HIDDEN)
    shapes = jax.eval_shape(
        lambda: vae.init(jax.random.PRNGKey(1), jnp.zeros((1, TINY_H, TINY_W, 3)))
    )
    return vae, random_params_like(shapes, seed)


def port_unet(params):
    from live2diff_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig

    unet = UNet3DConditionModel(UNetConfig(**TINY_UNET))
    unet.load_state_dict(params_from_jax(params), strict=True)
    return unet.eval()


def port_taesd(params):
    from live2diff_tpu_torch.models.vae import TinyAutoencoder

    vae = TinyAutoencoder(hidden=VAE_HIDDEN)
    vae.load_state_dict(params_from_jax(params), strict=True)
    return vae.eval()


def rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def caches_to_np(caches):
    """Flatten a cache tuple (float or int8 pairs, either framework) to numpy."""
    out = []
    for c in caches:
        out.extend(to_np(x) for x in (c if isinstance(c, tuple) else (c,)))
    return out
