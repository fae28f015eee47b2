"""The port against the JAX package at the widths it ships at, on the CPU.

The parity tests (``tests/test_torch_*.py``) hold each port module to its
JAX twin at tiny widths. This harness holds them at production width:

1. ``clip``: ``CLIPTextConfig()`` (123 M parameters) on a fixed prompt, at
   clip_skip 0 and 2;
2. ``taesd``: TAESD at hidden 64, encode and decode at 512x512;
3. ``dpt``: the DPT-hybrid at ``DPTConfig()`` on a 384x384 image: the depth
   map and the four fusion inputs (the projected ResNet stages and ViT
   hooks, ``layer1_rn`` ... ``layer4_rn``);
4. ``unet``: the ``UNetConfig()`` UNet at a 64x64 latent (512x512 frames):
   the warmup call over 8 frames, then 2 stream calls, with an fp32 and an
   int8 cache: the outputs and all 40 KV caches. Here the JAX attention
   takes its blockwise route (above 16 M logits) and the flash gate's
   lengths (S = 4096 and 1024) are met;
5. ``stream``: ``StreamDiffusionDepth`` with the full UNet, TAESD and the
   DPT-hybrid at 64x64 frames: ``prepare`` on 8 frames then 20 frames,
   through the window fill and eviction, with both cache dtypes, with and
   without depth (the full-width twin of ``tests/test_torch_pipeline.py``);
6. ``tp``: the port's ``flagship_stream_tp_check`` on two gloo ranks, fp32,
   at the JAX bound 2e-4 (port only: the unsharded step is the reference).

``tiny=True`` runs every item at ``tests/_torch_parity.py``'s widths (item 6
at the tp dryrun's UNet), which tier-1 does (``tests/test_torch_fullwidth.py``).

Weights: both sides take the same numpy draws, carried into the port by
``params_from_jax`` (CLIP by its HF state dict, through the JAX package's
``clip_torch_to_flax`` and the port's ``load_into``, as
``tests/test_torch_text.py`` does). The fill rule is ``_torch_parity.py``'s:
kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), every other leaf
(biases, embeddings, the zero-initialised projections too) N(0, 0.05^2), so
that a signal crosses the whole model. Each leaf is a slice, at an offset
drawn from the seed, of one shared pool of normal draws (as
``live2diff_tpu/builder.py:_random_params_like`` fills its placeholders):
the UNet's 1.28 G parameters take seconds, not a minute. The stream's noise
is the JAX draws replayed into torch. Everything runs in fp32.

Each reading is the relative RMS error and the largest error over the
largest value (``rel_err``, which the tolerances bound) of the port's output
against the JAX one. Each of items 1-5 has a control: the same port module
with one inner parameter set to 0 must read above the item's fp32
tolerance, so the comparison sees inside the model. Under an int8 cache
that control is shown but not held: the dropped parameter moves the
outputs by less than INT8_TOL, a few quantisation steps, so the int8
readings hold the quantised cache path and the fp32 ones the model. A
reading over its tolerance stands only as fp32 rounding, shown against the
JAX package's fp64 result (``Report``).
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import NARROW_DPT, TINY_DPT, TINY_UNET, caches_to_np, rel_err, to_np

# tolerances: tests/test_torch_models.py (TOL, INT8_TOL) for items 1-4,
# tests/test_torch_pipeline.py's INT8_TOL for item 5's int8 frames, and the
# JAX flagship tp check's bound (live2diff_tpu/parallel/infer.py:109) for
# item 6
MODULE_TOL = 1e-5
INT8_TOL = 2e-2
TP_TOL = 2e-4
# item 5's fp32 frames: tighter than tests/test_torch_pipeline.py's 1e-3,
# which the UNet's mid_block.resnets.0.norm1.bias dropped stays under at
# full width (6.4e-4 at the worst frame); sound frames read at most 3.5e-5
# at either width (PERF.md §6, the full-width findings)
STREAM_FP32_TOL = 2e-4
# a reading over its tolerance is fp32 rounding when the port's output is
# within this factor of the JAX fp32 output's own distance from the JAX
# package's fp64 result (Report.rounding)
ROUNDING_SLACK = 2.0

ITEMS = ("clip", "taesd", "dpt", "unet", "stream", "tp")

TINY_CLIP = dict(vocab_size=600, hidden_size=32, num_layers=3, num_heads=4,
                 intermediate_size=64, max_position_embeddings=77)
PROMPT = "a cat in the rain, masterpiece, best quality"

# the parameter each control sets to 0, by item ("{mid}": a middle layer
# that every output read depends on)
UNET_CONTROL = "mid_block.resnets.0.norm1.bias"
CLIP_CONTROL = "text_model.encoder.layers.{mid}.layer_norm1.bias"
TAESD_CONTROLS = ("encoder.8.conv.2.bias", "decoder.9.conv.2.bias")
DPT_CONTROL = "pretrained.model.blocks.{mid}.norm1.bias"

POOL_SIZE = 1 << 24
_POOL: List[np.ndarray] = []


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def _pool() -> np.ndarray:
    if not _POOL:
        _POOL.append(np.random.default_rng(1234).standard_normal(POOL_SIZE, dtype=np.float32))
    return _POOL[0]


def _take(n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` pool draws from an offset drawn from ``rng`` (the pool tiled
    where a leaf runs past its end)."""
    pool, start = _pool(), int(rng.integers(0, POOL_SIZE))
    if start + n <= POOL_SIZE:
        return pool[start:start + n]
    return np.tile(pool, -(-(start + n) // POOL_SIZE))[start:start + n]


def fan_in_leaf(kind: str, shape, fan_in: int, rng: np.random.Generator) -> np.ndarray:
    """One leaf by the fill rule: ``kind`` "kernel" N(0, 1/fan_in),
    "scale" 1 + N(0, 0.1^2), anything else N(0, 0.05^2)."""
    flat = _take(int(np.prod(shape)), rng).reshape(shape)
    if kind == "kernel":
        return flat * np.float32(1.0 / math.sqrt(fan_in))
    if kind == "scale":
        return np.float32(1.0) + np.float32(0.1) * flat
    return np.float32(0.05) * flat


def pooled_params_like(shapes, seed: int):
    """A numpy fp32 tree for a flax ``eval_shape`` tree, by the fill rule
    (a kernel's fan-in: every axis but its last)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        return fan_in_leaf(name, leaf.shape, int(np.prod(leaf.shape[:-1])), rng)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def clip_state_dict(cfg: dict, seed: int) -> Dict[str, np.ndarray]:
    """An HF-layout CLIP text state dict by the fill rule (a Linear weight
    ``[out, in]`` has fan-in ``in``)."""
    rng = np.random.default_rng(seed)
    h, f, n = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_layers"]
    shapes = {"text_model.embeddings.token_embedding.weight": (cfg["vocab_size"], h),
              "text_model.embeddings.position_embedding.weight": (77, h),
              "text_model.final_layer_norm.weight": (h,),
              "text_model.final_layer_norm.bias": (h,)}
    for i in range(n):
        p = f"text_model.encoder.layers.{i}"
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[f"{p}.self_attn.{nm}.weight"] = (h, h)
            shapes[f"{p}.self_attn.{nm}.bias"] = (h,)
        for nm in ("layer_norm1", "layer_norm2"):
            shapes[f"{p}.{nm}.weight"] = (h,)
            shapes[f"{p}.{nm}.bias"] = (h,)
        shapes.update({f"{p}.mlp.fc1.weight": (f, h), f"{p}.mlp.fc1.bias": (f,),
                       f"{p}.mlp.fc2.weight": (h, f), f"{p}.mlp.fc2.bias": (h,)})

    def kind(name, shape):
        if "embedding" in name or name.endswith("bias"):
            return "bias"
        return "scale" if len(shape) == 1 else "kernel"

    return {k: fan_in_leaf(kind(k, s), s, s[-1], rng) for k, s in shapes.items()}


def nudged(x: np.ndarray, share: float = 0.01, seed: int = 0) -> np.ndarray:
    """``x`` with ``share`` of its elements moved to the next fp32 value up."""
    out = np.array(x, np.float32, copy=True)
    flat = out.reshape(-1)
    pick = np.random.default_rng(seed).random(flat.size) < share
    flat[pick] = np.nextafter(flat[pick], np.float32(np.inf))
    return out


def _jax_tree(tree):
    """A numpy tree as JAX arrays (each leaf copied once)."""
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _port_module(make: Callable[[], torch.nn.Module], state: Dict[str, torch.Tensor]):
    """``make()`` built without allocating its parameters, then given
    ``state``'s tensors (strict: every parameter named, no other)."""
    with torch.device("meta"):
        module = make()
    module.load_state_dict(state, strict=True, assign=True)
    return module.eval()


@contextlib.contextmanager
def zeroed(module: torch.nn.Module, *names: str):
    """The named parameters of ``module`` set to 0 inside the block."""
    params = dict(module.named_parameters())
    kept = {n: params[n].detach().clone() for n in names}
    with torch.no_grad():
        for n in names:
            params[n].zero_()
    try:
        yield module
    finally:
        with torch.no_grad():
            for n, v in kept.items():
                params[n].copy_(v)


# ---------------------------------------------------------------------------
# readings
# ---------------------------------------------------------------------------


def reading(ours, ref) -> dict:
    """``rel_rms`` and ``max_rel`` (largest error over largest value) of
    ``ours`` against ``ref``."""
    a, b = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    if a.shape != b.shape:
        raise AssertionError(f"shape {a.shape}, reference {b.shape}")
    if not np.isfinite(a).all():
        raise AssertionError("a non-finite value")
    rms = math.sqrt(float(np.mean((a - b) ** 2)) / max(float(np.mean(b ** 2)), 1e-300))
    return {"rel_rms": rms, "max_rel": rel_err(a, b)}


def caches_reading(ours: List[np.ndarray], ref: List[np.ndarray], int8: bool) -> dict:
    """The worst reading over every cache: ``caches_to_np`` lists (int8
    caches as code and scale arrays in turn, compared dequantised)."""
    if int8:
        ours, ref = ([d.astype(np.float64) * s[..., None] for d, s in zip(x[0::2], x[1::2])]
                     for x in (ours, ref))
    if len(ours) != len(ref):
        raise AssertionError(f"{len(ours)} caches, reference {len(ref)}")
    rs = [reading(a, b) for a, b in zip(ours, ref)]
    return {"rel_rms": max(r["rel_rms"] for r in rs), "max_rel": max(r["max_rel"] for r in rs),
            "caches": len(rs)}


class Report:
    """One item's readings and controls.

    * ``add``: a reading against its tolerance. One over it is a fault
      unless ``rounding`` shows it is fp32 rounding: the port's output is no
      farther than ``ROUNDING_SLACK`` times as far from the JAX package's
      fp64 result as the JAX package's own fp32 output is.
    * ``control``: a reading of the port with one parameter set to 0, which
      must read above its tolerance (the comparison sees inside the model).
    * ``info``: a reading shown, not held to a limit (the same parameter
      dropped under an int8 cache, and the JAX side's own nudges).
    """

    def __init__(self, item: str, tiny: bool):
        self.item, self.tiny = item, tiny
        self.readings: Dict[str, dict] = {}
        self.controls: Dict[str, dict] = {}
        self.infos: Dict[str, dict] = {}
        self.roundings: Dict[str, dict] = {}
        self.notes: Dict[str, object] = {}
        self.t0 = time.perf_counter()

    def add(self, label: str, r: dict, tol: float) -> None:
        self.readings[label] = dict(r, tol=tol)

    def control(self, label: str, r: dict, tol: float) -> None:
        self.controls[label] = dict(r, tol=tol)

    def info(self, label: str, r: dict) -> None:
        self.infos[label] = dict(r)

    def rounding(self, label: str, port_vs_f64: dict, jax_vs_f64: dict) -> None:
        self.roundings[label] = {"port_vs_f64": port_vs_f64["max_rel"],
                                 "jax_vs_f64": jax_vs_f64["max_rel"]}

    def over(self) -> List[str]:
        return [k for k, v in self.readings.items() if not v["max_rel"] < v["tol"]]

    def _rounding_only(self, label: str) -> bool:
        r = self.roundings.get(label)
        return r is not None and r["port_vs_f64"] <= ROUNDING_SLACK * r["jax_vs_f64"]

    @property
    def faults(self) -> List[str]:
        out = [f"{k}: {self.readings[k]['max_rel']:.3e} > {self.readings[k]['tol']:g}"
               for k in self.over() if not self._rounding_only(k)]
        out += [f"control {k}: {v['max_rel']:.3e} <= {v['tol']:g}"
                for k, v in self.controls.items() if not v["max_rel"] > v["tol"]]
        return out

    def as_dict(self) -> dict:
        return {"item": self.item, "tiny": self.tiny, "readings": self.readings,
                "controls": self.controls, "infos": self.infos, "roundings": self.roundings,
                "notes": self.notes, "faults": self.faults,
                "seconds": time.perf_counter() - self.t0}


def _log(msg: str) -> None:
    print(msg, flush=True)


def _free() -> None:
    gc.collect()
    jax.clear_caches()


def check_rounding(rep: Report, ours: dict, ref: dict, ref64: Callable[[], dict],
                   nudged_ref: Callable[[], dict]) -> None:
    """For each of ``rep``'s readings over its tolerance, the port's and the
    JAX package's distance from the JAX package's fp64 result (``ref64()``:
    the outputs by label with fp64 convs and matmuls, under x64; its norms
    keep fp32 statistics), and, shown, how far the JAX outputs move when 1 %
    of the input moves by one ulp (``nudged_ref()``)."""
    over = rep.over()
    if not over:
        return
    with jax.enable_x64():
        exact = {k: np.asarray(v) for k, v in ref64().items()}
    moved = {k: np.asarray(v) for k, v in nudged_ref().items()}
    for k in over:
        rep.rounding(k, reading(ours[k], exact[k]), reading(ref[k], exact[k]))
        rep.info(f"{k}: JAX with 1 % of its input moved by one ulp", reading(moved[k], ref[k]))


def _f64(params):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), params)


@contextlib.contextmanager
def _convs_at_input_precision():
    """``jax.lax.conv_general_dilated`` without its ``preferred_element_type``
    while the block runs: TAESD's convs ask for fp32 accumulation
    (``live2diff_tpu/models/vae.py:250-254``), which an fp64 run refuses."""
    real = jax.lax.conv_general_dilated

    def conv(*args, preferred_element_type=None, **kwargs):
        return real(*args, **kwargs)

    jax.lax.conv_general_dilated = conv
    try:
        yield
    finally:
        jax.lax.conv_general_dilated = real


# ---------------------------------------------------------------------------
# 1. CLIP
# ---------------------------------------------------------------------------


def item_clip(tiny: bool = False) -> Report:
    from live2diff_tpu.convert.torch_to_flax import clip_torch_to_flax
    from live2diff_tpu.models.text_encoder import CLIPTextConfig as JaxCLIPTextConfig
    from live2diff_tpu.models.text_encoder import CLIPTextModelWithFinalNorm as JaxCLIP
    from live2diff_tpu_torch.convert.checkpoint import load_into
    from live2diff_tpu_torch.models.text_encoder import (
        CLIPTextConfig, CLIPTextModelWithFinalNorm,
    )
    from live2diff_tpu_torch.utils.tokenizer import CLIPTokenizer

    rep = Report("clip", tiny)
    cfg = TINY_CLIP if tiny else {}
    widths = {**vars(CLIPTextConfig()), **cfg}
    sd = clip_state_dict(widths, seed=11)
    jmodel = JaxCLIP(config=JaxCLIPTextConfig(**cfg), dtype=jnp.float32)
    params, _ = clip_torch_to_flax(sd)
    tmodel = CLIPTextModelWithFinalNorm(CLIPTextConfig(**cfg)).eval()
    missing: List[str] = []
    load_into(tmodel, {k: torch.from_numpy(v) for k, v in sd.items()}, missing)
    if missing:
        raise AssertionError(f"CLIP: unloaded parameters {missing}")
    del sd
    ids = CLIPTokenizer.tiny(model_max_length=77)([PROMPT])
    # clip_skip 2 reads the hidden state 3 layers before the end
    control = CLIP_CONTROL.format(mid=(widths["num_layers"] - 3) // 2)
    for skip in (0, 2):
        ref = np.asarray(jax.jit(lambda p, i, s=skip: jmodel.apply(p, i, clip_skip=s))(
            params, jnp.asarray(ids)))
        with torch.no_grad():
            x = torch.from_numpy(ids.astype(np.int64))
            rep.add(f"clip_skip {skip}", reading(tmodel(x, clip_skip=skip).numpy(), ref),
                    MODULE_TOL)
            with zeroed(tmodel, control):
                rep.control(f"clip_skip {skip}, {control} = 0",
                            reading(tmodel(x, clip_skip=skip).numpy(), ref), MODULE_TOL)
    rep.notes["parameters"] = sum(p.numel() for p in tmodel.parameters())
    return rep


# ---------------------------------------------------------------------------
# 2. TAESD
# ---------------------------------------------------------------------------


def item_taesd(tiny: bool = False) -> Report:
    from live2diff_tpu.models.vae import TinyAutoencoder as JaxTinyAutoencoder
    from live2diff_tpu_torch.convert.from_jax import params_from_jax
    from live2diff_tpu_torch.models.vae import TinyAutoencoder

    rep = Report("taesd", tiny)
    hidden, size = (8, 64) if tiny else (64, 512)
    vae = JaxTinyAutoencoder(hidden=hidden)
    shapes = jax.eval_shape(lambda: vae.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3))))
    tree = pooled_params_like(shapes, seed=12)
    tvae = _port_module(lambda: TinyAutoencoder(hidden=hidden), params_from_jax(tree))
    params = _jax_tree(tree)
    del tree
    rs = np.random.RandomState(7)
    x = rs.uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    z = (2.0 * rs.randn(1, size // 8, size // 8, 4)).astype(np.float32)

    def run(model, p, a, b):
        return {"encode": jax.jit(lambda p, a: model.apply(p, a, method=model.encode))(p, a),
                "decode": jax.jit(lambda p, b: model.apply(p, b, method=model.decode))(p, b)}

    ref = {k: np.asarray(v) for k, v in run(vae, params, x, z).items()}
    with torch.no_grad():
        ours = {"encode": tvae.encode(torch.from_numpy(x)).numpy(),
                "decode": tvae.decode(torch.from_numpy(z)).numpy()}
        with zeroed(tvae, *TAESD_CONTROLS):
            bad = {"encode": tvae.encode(torch.from_numpy(x)).numpy(),
                   "decode": tvae.decode(torch.from_numpy(z)).numpy()}
    for k, name in zip(ours, TAESD_CONTROLS):
        rep.add(k, reading(ours[k], ref[k]), MODULE_TOL)
        rep.control(f"{k}, {name} = 0", reading(bad[k], ref[k]), MODULE_TOL)
    vae64 = JaxTinyAutoencoder(hidden=hidden, dtype=jnp.float64, param_dtype=jnp.float64)

    def ref64():
        with _convs_at_input_precision():
            out = run(vae64, _f64(params), x.astype(np.float64), z.astype(np.float64))
            return {k: np.asarray(v) for k, v in out.items()}

    check_rounding(rep, ours, ref, ref64, lambda: run(vae, params, nudged(x), nudged(z)))
    rep.notes["parameters"] = sum(p.numel() for p in tvae.parameters())
    return rep


# ---------------------------------------------------------------------------
# 3. DPT-hybrid
# ---------------------------------------------------------------------------

FUSION_INPUTS = ("layer1_rn", "layer2_rn", "layer3_rn", "layer4_rn")


def _port_fusion_inputs(tdpt, x: torch.Tensor) -> dict:
    """The port DPT's depth map and its four fusion inputs: each
    ``refinenetN`` takes ``layerN_rn``'s output as its last argument."""
    taken = {}
    hooks = [getattr(tdpt.scratch, f"refinenet{i}").register_forward_pre_hook(
        lambda mod, args, i=i: taken.__setitem__(f"layer{i}_rn", args[-1].numpy().copy()))
        for i in range(1, 5)]
    try:
        with torch.no_grad():
            depth = tdpt(x).numpy()
    finally:
        for h in hooks:
            h.remove()
    return {"depth": depth, **taken}


def item_dpt(tiny: bool = False) -> Report:
    from live2diff_tpu.models.midas import DPTConfig as JaxDPTConfig
    from live2diff_tpu.models.midas import DPTDepthModel as JaxDPTDepthModel
    from live2diff_tpu_torch.convert.from_jax import dpt_torch_key, params_from_jax
    from live2diff_tpu_torch.models.midas import DPTConfig, DPTDepthModel

    rep = Report("dpt", tiny)
    cfg = dict(TINY_DPT) if tiny else {}
    jcfg = JaxDPTConfig(**cfg)
    size = jcfg.image_size
    dpt = JaxDPTDepthModel(config=jcfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: dpt.init(jax.random.PRNGKey(2), jnp.zeros((1, size, size, 3))))
    tree = pooled_params_like(shapes, seed=13)
    tdpt = _port_module(lambda: DPTDepthModel(DPTConfig(**cfg)),
                        params_from_jax(tree, key=dpt_torch_key))
    params = _jax_tree(tree)
    del tree
    x = np.random.RandomState(8).uniform(-1, 1, (1, size, size, 3)).astype(np.float32)

    def taps_of(model):
        def run(p, a):
            out, state = model.apply(p, a, mutable=["intermediates"],
                                     capture_intermediates=lambda m, _: m.name in FUSION_INPUTS)
            return {"depth": out,
                    **{k: state["intermediates"][k]["__call__"][0] for k in FUSION_INPUTS}}
        return jax.jit(run)

    run = taps_of(dpt)
    ref = {k: np.asarray(v) for k, v in run(params, x).items()}
    ours = _port_fusion_inputs(tdpt, torch.from_numpy(x))
    for k in ref:
        rep.add(k, reading(ours[k], ref[k]), MODULE_TOL)
    control = DPT_CONTROL.format(mid=jcfg.hooks[0] - 1)
    with zeroed(tdpt, control):
        bad = _port_fusion_inputs(tdpt, torch.from_numpy(x))
    for k in ("depth", "layer3_rn"):
        rep.control(f"{k}, {control} = 0", reading(bad[k], ref[k]), MODULE_TOL)
    dpt64 = JaxDPTDepthModel(config=jcfg, dtype=jnp.float64, param_dtype=jnp.float64)
    check_rounding(rep, ours, ref,
                   lambda: taps_of(dpt64)(_f64(params), x.astype(np.float64)),
                   lambda: run(params, nudged(x)))
    rep.notes["parameters"] = sum(p.numel() for p in tdpt.parameters())
    rep.notes["depth_std"] = float(ref["depth"].std())
    return rep


# ---------------------------------------------------------------------------
# 4. the UNet at a 64x64 latent
# ---------------------------------------------------------------------------


def _unet_tree(tiny: bool, latent: int, seed: int = 14):
    """(JAX UNet, its numpy tree by the fill rule)."""
    from live2diff_tpu.models.unet import UNet3DConditionModel as JaxUNet
    from live2diff_tpu.models.unet import UNetConfig as JaxUNetConfig
    from live2diff_tpu.stream.state_machine import init_window_state, mask_to_bias

    cfg = JaxUNetConfig(**(TINY_UNET if tiny else {}))
    unet = JaxUNet(config=cfg, dtype=jnp.float32)
    caches = cfg.init_caches(latent, latent, 2, dtype=jnp.float32)
    mask, pe_idx, update_idx = init_window_state(2)
    z = jnp.zeros((2, 1, latent, latent, 4))
    shapes = jax.eval_shape(lambda: unet.init(
        jax.random.PRNGKey(0), z, jnp.zeros((2,), jnp.int32),
        jnp.zeros((2, 7, cfg.cross_attention_dim)), z, caches, "stream",
        mask_to_bias(mask), pe_idx, update_idx))
    return unet, pooled_params_like(shapes, seed)


def _port_unet(tiny: bool, jparams) -> torch.nn.Module:
    """The port's UNet on the JAX tree's weights (read through numpy)."""
    from live2diff_tpu_torch.convert.from_jax import params_from_jax
    from live2diff_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig

    return _port_module(lambda: UNet3DConditionModel(UNetConfig(**(TINY_UNET if tiny else {}))),
                        params_from_jax(jparams))


def _unet_inputs(cross_dim: int, latent: int, text_len: int) -> dict:
    rs = np.random.RandomState(15)
    f32 = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    return {"ctx": f32(2, text_len, cross_dim), "xw": f32(1, 8, latent, latent, 4),
            "dw": f32(1, 8, latent, latent, 4),
            "stream": [(f32(2, 1, latent, latent, 4), f32(2, 1, latent, latent, 4))
                       for _ in range(2)]}


def _jax_unet_run(unet, params, inp: dict, int8: bool):
    """The warmup call and 2 stream calls: ([(label, output)], the caches
    after the last call as ``caches_to_np`` arrays)."""
    from live2diff_tpu.stream.state_machine import (
        init_window_state, mask_to_bias, update_window_state,
    )

    lat = inp["xw"].shape[2]
    caches = unet.config.init_caches(lat, lat, 2, dtype=jnp.int8 if int8 else jnp.float32)
    apply = jax.jit(unet.apply, static_argnums=(6, 10))
    out, caches = apply(params, inp["xw"], jnp.array([261]), inp["ctx"][:1], inp["dw"], caches,
                        "warmup", None, None, None, 0)
    outs = [("warmup", np.asarray(out))]
    mask, pe_idx, update_idx = init_window_state(2)
    for i, (xs, ds) in enumerate(inp["stream"]):
        out, caches = apply(params, xs, jnp.array([261, 61]), inp["ctx"], ds, caches, "stream",
                            mask_to_bias(mask), pe_idx, update_idx)
        outs.append((f"stream {i + 1}", np.asarray(out)))
        mask, pe_idx, update_idx = update_window_state(mask, pe_idx, update_idx)
    return outs, caches_to_np(caches)


def _port_unet_run(tunet, inp: dict, int8: bool):
    """The same three calls through the port's UNet."""
    from live2diff_tpu_torch.stream import state_machine as tsm

    T = torch.from_numpy
    lat = inp["xw"].shape[2]
    caches = tunet.config.init_caches(lat, lat, 2, dtype=torch.int8 if int8 else torch.float32,
                                      device="cpu")
    with torch.no_grad():
        out, caches = tunet(T(inp["xw"]), torch.tensor([261]), T(inp["ctx"][:1]), T(inp["dw"]),
                            caches, "warmup", None, None, None, 0)
        outs = [("warmup", out.numpy())]
        mask, pe_idx, update_idx = tsm.init_window_state(2)
        for i, (xs, ds) in enumerate(inp["stream"]):
            out, caches = tunet(T(xs), torch.tensor([261, 61]), T(inp["ctx"]), T(ds), caches,
                                "stream", tsm.mask_to_bias(mask), pe_idx, update_idx)
            outs.append((f"stream {i + 1}", out.numpy()))
            tsm.update_window_state(mask, pe_idx, update_idx, out=(mask, pe_idx, update_idx))
    return outs, caches_to_np(caches)


def item_unet(tiny: bool = False, spill_dir: Optional[str] = None) -> Report:
    """The JAX calls run first and leave their caches in ``spill_dir`` (at
    full width 5.7 GiB an fp32 set; the caches after the last call hold
    every slot the three calls wrote), so that the two models and their
    caches are never in memory together."""
    rep = Report("unet", tiny)
    latent = 8 if tiny else 64
    unet, tree = _unet_tree(tiny, latent)
    params = _jax_tree(tree)
    del tree
    inp = _unet_inputs(unet.config.cross_attention_dim, latent, 7 if tiny else 77)
    with tempfile.TemporaryDirectory(dir=spill_dir) as spill:
        refs = {}
        for cache in ("fp32", "int8"):
            t0 = time.perf_counter()
            outs, caches = _jax_unet_run(unet, params, inp, cache == "int8")
            paths = []
            for n, arr in enumerate(caches):
                paths.append(os.path.join(spill, f"{cache}-{n}.npy"))
                np.save(paths[-1], arr)
            refs[cache] = (outs, paths)
            del caches
            _free()
            rep.notes[f"jax {cache} s"] = time.perf_counter() - t0
        tunet = _port_unet(tiny, params)
        del params
        _free()
        for cache in ("fp32", "int8"):
            int8 = cache == "int8"
            tol = INT8_TOL if int8 else MODULE_TOL
            ref_outs, paths = refs[cache]
            t0 = time.perf_counter()
            outs, caches = _port_unet_run(tunet, inp, int8)
            rep.notes[f"port {cache} s"] = time.perf_counter() - t0
            for (label, out), (_, ref) in zip(outs, ref_outs):
                # the warmup attends over its own frames, not the cache
                rep.add(f"{cache} cache: {label} output", reading(out, ref),
                        MODULE_TOL if label == "warmup" else tol)
            rep.add(f"{cache} cache: the caches after the last call",
                    caches_reading(caches, [np.load(p, mmap_mode="r") for p in paths], int8),
                    tol)
            del caches
            if int8:  # the stream item shows the control under an int8 cache
                continue
            with zeroed(tunet, UNET_CONTROL):
                bad, _ = _port_unet_run(tunet, inp, int8)
            for (label, out), (_, ref) in zip(bad, ref_outs):
                rep.control(f"{cache} cache: {label} output, {UNET_CONTROL} = 0",
                            reading(out, ref), MODULE_TOL)
    rep.notes["parameters"] = sum(p.numel() for p in tunet.parameters())
    rep.notes["self-attention logits at the top level"] = {
        "warmup": 8 * 8 * (latent * latent) ** 2, "stream": 2 * 8 * (latent * latent) ** 2}
    return rep


# ---------------------------------------------------------------------------
# 5. the whole stream at 64x64 frames
# ---------------------------------------------------------------------------

WARM, STREAM_FRAMES, STREAM_SIZE, STREAM_SEED = 8, 20, 64, 5
STREAM_RUNS = (("fp32", False), ("int8", False), ("fp32", True), ("int8", True))


def _stream_frames(n: int) -> np.ndarray:
    """A slowly varying stream in [-1, 1] (``tests/test_torch_pipeline.py``'s)."""
    rs = np.random.RandomState(99)
    size = STREAM_SIZE
    base = rs.rand(size, size, 3).astype(np.float32)
    out = []
    for i in range(n):
        drift = 0.1 * np.sin(0.3 * i + np.linspace(0, 3, size))[:, None, None]
        detail = 0.05 * rs.rand(size, size, 3).astype(np.float32)
        out.append((np.clip(base + drift + detail, 0, 1) * 2 - 1).astype(np.float32))
    return np.stack(out)


class _Replay:
    """The port's noise function: hands out recorded JAX draws in order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, shape):
        arr = self.draws.pop(0)
        if tuple(arr.shape) != tuple(shape):
            raise AssertionError(f"noise {arr.shape}, asked {tuple(shape)}")
        return torch.from_numpy(np.array(arr))


def _normal(key, shape) -> np.ndarray:
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _jax_stream_run(unet, params, vae, vae_params, dpt, dpt_params, cache: str, prompt,
                    frames):
    """prepare + the frames through the JAX stream: (outputs, the noise
    draws of each call, warmup first)."""
    from live2diff_tpu.schedule import LCMSchedule as JaxLCMSchedule
    from live2diff_tpu.stream.pipeline import StreamConfig as JaxStreamConfig
    from live2diff_tpu.stream.pipeline import StreamDiffusionDepth as JaxStream

    pipe = JaxStream(
        unet, params, JaxLCMSchedule.create(50, t_index_list=[30, 40]),
        JaxStreamConfig(height=STREAM_SIZE, width=STREAM_SIZE,
                        cache_dtype={"fp32": jnp.float32, "int8": jnp.int8}[cache]),
        lambda p, x: vae.apply(p, x, method=vae.encode),
        lambda p, z: vae.apply(p, z, method=vae.decode),
        depth_fn=None if dpt is None else dpt.apply, vae_params=vae_params,
        depth_params=dpt_params)
    lat = STREAM_SIZE // 8
    state, warm = pipe.prepare(frames[:WARM], jnp.asarray(prompt), seed=STREAM_SEED)
    rng, r_enc = jax.random.split(jax.random.PRNGKey(STREAM_SEED))
    draws = [_normal(r_enc, (WARM, lat, lat, 4))]
    rng, r = jax.random.split(rng)
    draws.append(_normal(r, (WARM, lat, lat, 4)))  # the second of the 2 steps
    outs, calls = [np.asarray(warm)], [draws]
    for frame in frames[WARM:]:
        _, r_enc, r_buf = jax.random.split(state.rng, 3)
        calls.append([_normal(r_enc, (1, lat, lat, 4)), _normal(r_buf, (1, lat, lat, 4))])
        state, out = pipe(state, frame)
        outs.append(np.asarray(out))
    return outs, calls


def _port_stream_run(tunet, tvae, tdpt, cache: str, prompt, frames, calls):
    from live2diff_tpu_torch.schedule import LCMSchedule
    from live2diff_tpu_torch.stream.pipeline import StreamConfig, StreamDiffusionDepth

    pipe = StreamDiffusionDepth(
        tunet, tvae, LCMSchedule.create(50, t_index_list=[30, 40]),
        StreamConfig(height=STREAM_SIZE, width=STREAM_SIZE,
                     cache_dtype={"fp32": torch.float32, "int8": torch.int8}[cache]),
        device="cpu", dtype=torch.float32, depth_model=tdpt)
    replay = _Replay(calls[0])
    state, warm = pipe.prepare(torch.from_numpy(frames[:WARM]), torch.from_numpy(prompt),
                               noise=replay)
    outs = [to_np(warm).copy()]
    for frame, draws in zip(frames[WARM:], calls[1:]):
        replay = _Replay(draws)
        state, out = pipe(state, torch.from_numpy(frame), noise=replay)
        if replay.draws:
            raise AssertionError(f"{len(replay.draws)} noise draws left unused")
        outs.append(to_np(out).copy())
    return outs


def item_stream(tiny: bool = False, frames: int = STREAM_FRAMES,
                runs=STREAM_RUNS) -> Report:
    """The JAX streams run first (their outputs and noise kept), then the
    port's on the same weights, then the controls (the UNet's
    ``UNET_CONTROL`` set to 0, each cache dtype, no depth)."""
    from live2diff_tpu.models.midas import DPTConfig as JaxDPTConfig
    from live2diff_tpu.models.midas import DPTDepthModel as JaxDPTDepthModel
    from live2diff_tpu.models.vae import TinyAutoencoder as JaxTinyAutoencoder
    from live2diff_tpu_torch.convert.from_jax import dpt_torch_key, params_from_jax
    from live2diff_tpu_torch.models.midas import DPTConfig, DPTDepthModel
    from live2diff_tpu_torch.models.vae import TinyAutoencoder

    rep = Report("stream", tiny)
    lat = STREAM_SIZE // 8
    unet, tree = _unet_tree(tiny, lat)
    params = _jax_tree(tree)
    del tree
    hidden = 8 if tiny else 64
    vae = JaxTinyAutoencoder(hidden=hidden)
    vae_tree = pooled_params_like(jax.eval_shape(lambda: vae.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))), seed=16)
    dcfg = dict(NARROW_DPT) if tiny else {}
    dpt = JaxDPTDepthModel(config=JaxDPTConfig(**dcfg), dtype=jnp.float32)
    size = JaxDPTConfig(**dcfg).image_size
    dpt_tree = pooled_params_like(jax.eval_shape(lambda: dpt.init(
        jax.random.PRNGKey(2), jnp.zeros((1, size, size, 3)))), seed=17)
    vae_params, dpt_params = _jax_tree(vae_tree), _jax_tree(dpt_tree)
    video = _stream_frames(WARM + frames)
    cross = unet.config.cross_attention_dim
    prompt = np.random.RandomState(23).randn(1, 7 if tiny else 77, cross).astype(np.float32)
    refs = {}
    for cache, depth in runs:
        t0 = time.perf_counter()
        refs[cache, depth] = _jax_stream_run(
            unet, params, vae, vae_params, dpt if depth else None,
            dpt_params if depth else None, cache, prompt, video)
        rep.notes[f"jax {cache} cache, depth {depth} s"] = time.perf_counter() - t0
        _free()
    tunet = _port_unet(tiny, params)
    del params, vae_params, dpt_params
    _free()
    tvae = _port_module(lambda: TinyAutoencoder(hidden=hidden), params_from_jax(vae_tree))
    tdpt = _port_module(lambda: DPTDepthModel(DPTConfig(**dcfg)),
                        params_from_jax(dpt_tree, key=dpt_torch_key))
    for (cache, depth), (ref, calls) in refs.items():
        tol = INT8_TOL if cache == "int8" else STREAM_FP32_TOL
        t0 = time.perf_counter()
        ours = _port_stream_run(tunet, tvae, tdpt if depth else None, cache, prompt, video, calls)
        rep.notes[f"port {cache} cache, depth {depth} s"] = time.perf_counter() - t0
        label = f"{cache} cache, {'with' if depth else 'no'} depth"
        for i, (a, b) in enumerate(zip(ours, ref)):
            rep.add(f"{label}: {'warmup' if i == 0 else f'frame {i - 1}'}", reading(a, b), tol)
        if not depth:
            with zeroed(tunet, UNET_CONTROL):
                bad = _port_stream_run(tunet, tvae, None, cache, prompt, video, calls)
            worst = max((reading(a, b) for a, b in zip(bad, ref)), key=lambda r: r["max_rel"])
            what = f"{label}: worst frame, {UNET_CONTROL} = 0"
            if cache == "fp32":
                rep.control(what, worst, tol)
            else:  # under INT8_TOL: shown, not held
                rep.info(what, worst)
    rep.notes["frames"] = frames
    return rep


# ---------------------------------------------------------------------------
# 6. the full-width tp step
# ---------------------------------------------------------------------------


def item_tp(tiny: bool = False) -> Report:
    """``flagship_stream_tp_check`` (at ``tiny``, ``tp_stream_check`` of the
    tp dryrun's UNet at the same bound) on two gloo ranks, fp32 on the CPU;
    ``tests/_torch_fullwidth_ranks.py`` is each rank."""
    from _torch_ranks import spawn

    rep = Report("tp", tiny)
    with tempfile.TemporaryDirectory() as out_dir:
        with open(os.path.join(out_dir, "args.json"), "w") as f:
            json.dump({"tiny": tiny, "tol": TP_TOL}, f)
        spawn("_torch_fullwidth_ranks", 2, out_dir, timeout=1800)
        ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(2)]
    for r, got in enumerate(ranks):
        rep.add(f"rank {r}: tp 2 step against the unsharded step", got["reading"], TP_TOL)
        rep.notes[f"rank {r}"] = got["notes"]
    return rep


# ---------------------------------------------------------------------------
# running the items
# ---------------------------------------------------------------------------

RUNNERS = {"clip": item_clip, "taesd": item_taesd, "dpt": item_dpt, "unet": item_unet,
           "stream": item_stream, "tp": item_tp}


def print_report(rep: dict) -> None:
    _log(f"== {rep['item']}{' (tiny)' if rep['tiny'] else ''}: {rep['seconds']:.1f} s")
    for kind, mark in (("readings", ""), ("controls", "control "), ("infos", "shown ")):
        for label, r in rep[kind].items():
            tol = f" (tol {r['tol']:g})" if "tol" in r else ""
            rms = "not read" if r["rel_rms"] is None else f"{r['rel_rms']:.3e}"
            _log(f"   {mark}{label}: rel RMS {rms}, max rel {r['max_rel']:.3e}{tol}")
    for label, r in rep["roundings"].items():
        _log(f"   rounding {label}: port {r['port_vs_f64']:.3e} and JAX {r['jax_vs_f64']:.3e} "
             f"from the JAX package's fp64 result (port at most {ROUNDING_SLACK:g}x)")
    if rep["notes"]:
        _log(f"   notes: {json.dumps(rep['notes'], default=str)}")
    _log(f"   {'FAULTS: ' + '; '.join(rep['faults']) if rep['faults'] else 'ok'}")


def run_items(items=ITEMS, tiny: bool = False, spill_dir: Optional[str] = None) -> List[dict]:
    """Each item in turn (its report printed as it ends): their reports."""
    out = []
    for item in items:
        kw = {"spill_dir": spill_dir} if item == "unet" else {}
        rep = RUNNERS[item](tiny=tiny, **kw).as_dict()
        print_report(rep)
        out.append(rep)
        _free()
    return out
