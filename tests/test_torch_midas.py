"""The port's DPT-hybrid depth model against the JAX package's, on the same weights.

Weights are drawn over the flax modules' ``eval_shape`` and carried across
with ``params_from_jax(..., key=dpt_torch_key)`` (``strict=True``). fp32 on
the CPU, where the two frameworks differ only in summation order: 1e-5
relative for one module, 1e-4 through the whole model (ResNet stages, ViT
blocks and the fusion decoder compound it). The state dict is also held to
the MiDaS checkpoint names: the JAX package's own checkpoint converter
(``live2diff_tpu/convert/midas.py``) must carry the port's keys back onto
the JAX parameter tree, value for value.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import NARROW_DPT, TINY_DPT, jax_dpt, port_dpt, random_params_like, rel_err
from live2diff_tpu.convert.midas import dpt_key_map, dpt_torch_to_flax
from live2diff_tpu.convert.torch_to_flax import convert_state_dict
from live2diff_tpu.models import midas as jm
from live2diff_tpu_torch.convert.from_jax import dpt_torch_key, params_from_jax
from live2diff_tpu_torch.models import midas as tm

T = torch.from_numpy
TOL = 1e-5
DPT_TOL = 1e-4


def _check(jmod, tmod, top: str, prefix: str, *args, tol=TOL):
    """Weights drawn over ``jmod``'s eval_shape, loaded into ``tmod`` under
    the checkpoint names the submodule has inside the DPT: ``top`` is its
    flax name there, ``prefix`` its checkpoint prefix. Then both run on
    ``args``."""
    jargs = [jnp.asarray(a) for a in args]
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jargs))
    params = random_params_like(shapes, seed=3)

    def key(path):
        return dpt_torch_key((top,) + tuple(p for p in path if p != "params"))[len(prefix):]

    tmod.load_state_dict(params_from_jax(params, key=key), strict=True)
    ref = jmod.apply(params, *jargs)
    with torch.no_grad():
        out = tmod.eval()(*map(T, args))
    assert tuple(out.shape) == tuple(ref.shape)
    assert rel_err(out.numpy(), ref) < tol


@pytest.mark.parametrize("k,stride,pad,bias", [(7, 2, 3, False), (3, 1, 1, True), (1, 2, 0, False)])
def test_std_conv_matches_jax(k, stride, pad, bias):
    x = np.random.RandomState(0).randn(2, 12, 10, 8).astype(np.float32)
    _check(jm.StdConv(16, (k, k), (stride, stride), padding=pad, use_bias=bias),
           tm.StdConv(8, 16, k, stride, pad, bias=bias), "stem_conv",
           "pretrained.model.patch_embed.backbone.stem.conv.", x)


@pytest.mark.parametrize("cin,stride", [(64, 2), (128, 1)])  # projection shortcut / identity
def test_resnet_bottleneck_matches_jax(cin, stride):
    x = np.random.RandomState(1).randn(2, 8, 8, cin).astype(np.float32)
    _check(jm.ResNetV2Bottleneck(128, stride=stride),
           tm.ResNetV2Bottleneck(cin, 128, stride), "stages_0_blocks_0",
           "pretrained.model.patch_embed.backbone.stages.0.blocks.0.", x)


def test_vit_block_matches_jax():
    x = np.random.RandomState(2).randn(2, 37, 16).astype(np.float32)
    _check(jm.ViTBlock(16, 2, 32), tm.ViTBlock(16, 2, 32), "vit_blocks_0",
           "pretrained.model.blocks.0.", x)


@pytest.mark.parametrize("skip", [True, False])
def test_feature_fusion_block_matches_jax(skip):
    rs = np.random.RandomState(4)
    args = [rs.randn(1, 6, 5, 8).astype(np.float32) for _ in range(1 + skip)]
    _check(jm.FeatureFusionBlock(8), tm.FeatureFusionBlock(8, has_skip=skip), "refinenet1",
           "scratch.refinenet1.", *args)


@pytest.mark.parametrize("cfg", [TINY_DPT, NARROW_DPT], ids=["tiny96", "narrow384"])
def test_dpt_matches_jax(cfg):
    dpt, params = jax_dpt(cfg)
    tdpt = port_dpt(params, cfg)
    size = cfg["image_size"]
    x = np.random.RandomState(5).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(dpt.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        out = tdpt(T(x)).numpy()
    assert out.shape == ref.shape == (2, size, size)
    assert (out >= 0).all()  # non-negative head
    assert ref.std() > 0.01  # a random head that gave a flat map would test nothing
    assert rel_err(out, ref) < DPT_TOL


def test_dpt_state_dict_keys_are_the_checkpoint_names():
    """Every port key is a MiDaS checkpoint name that ``dpt_key_map`` sends
    to the very JAX parameter ``params_from_jax`` carried into it, and the
    JAX converter rebuilds the whole JAX tree from the port's state dict."""
    _, params = jax_dpt(TINY_DPT)
    sd = port_dpt(params, TINY_DPT).state_dict()
    jax_leaves = {
        tuple(k.key for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_leaves_with_path(params)
    }
    carried = {dpt_torch_key(path): path for path in jax_leaves}
    assert set(carried) == set(sd)
    for key, arr in sd.items():
        assert dpt_key_map(key) is not None, key
        tree, skipped = convert_state_dict({key: arr.numpy()}, dpt_key_map)
        ((path, _),) = jax.tree_util.tree_leaves_with_path(tree)
        assert ("params",) + tuple(k.key for k in path) == carried[key], key
    rebuilt, skipped = dpt_torch_to_flax({k: v.numpy() for k, v in sd.items()})
    assert skipped == []
    rebuilt = {tuple(k.key for k in path): np.asarray(leaf)
               for path, leaf in jax.tree_util.tree_leaves_with_path(rebuilt)}
    assert set(rebuilt) == set(jax_leaves)
    for path, arr in jax_leaves.items():
        np.testing.assert_array_equal(rebuilt[path], arr, err_msg=str(path))


def test_dpt_full_config_parameter_count():
    """The full vitb_rn50_384 DPT, built without memory: the JAX package's
    121,196,289 parameters."""
    with torch.device("meta"):
        dpt = tm.DPTDepthModel(tm.DPTConfig())
    assert sum(p.numel() for p in dpt.parameters()) == 121_196_289
    assert dpt.pretrained.model.pos_embed.shape == (1, 24 * 24 + 1, 768)
    assert dpt.pretrained.model.patch_embed.proj.weight.shape == (768, 1024, 1, 1)
    assert len(dpt.pretrained.model.blocks) == 12
    assert len(dpt.pretrained.model.patch_embed.backbone.stages[2].blocks) == 9
