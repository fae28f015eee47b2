"""Multi-rank inference: the tp-sharded stream step and dp-sharded sessions.

Port of ``live2diff_tpu/parallel/infer.py``. The (dp, tp) mesh that trains
the motion modules also serves them:

* tp, over one stream step: the UNet's blocks are cut by
  ``parallel/tp.shard_params`` and each rank's KV caches hold the channel
  slab of its heads (``cache_sharding``, ``UNetConfig.init_caches(tp=)``),
  so cache reads and writes stay on the rank; each block meets its peers
  in one ``all_reduce``. The step runs eagerly: a CUDA graph cannot
  capture the collectives' host side under gloo.
* dp, over sessions: each dp rank runs ``stream/multi.py:MultiStream`` over
  its own sessions, with no collective at all.

``flagship_train_lowering_check`` lowers the flagship train step to
StableHLO and has no torch counterpart (there is nothing to lower). Its
role, the train step of the full-width ``UNetConfig()`` over the mesh, is
covered by executing that step: ``chip_smoke.py`` phase 18 (c) trains it
at tp = 2 on the card against one process.

The dryruns take the device's stream dtypes: fp32 and an fp32 cache on the
CPU, as the JAX dryruns run; bf16 and an int8 cache on the card, whose
stream-attention kernels take no fp32 cache. Their tiny UNet is the JAX
dryrun's at twice its widths, so that every head is 8 wide: the card's
flash kernels take D % 8 == 0.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..builder import resolve_device
from ..convert.checkpoint import channels_last_convs_
from ..models.unet import UNet3DConditionModel, UNetConfig
from ..ops import _build
from ..stream.state import KVCache
from ..stream.state_machine import init_window_state, mask_to_bias, update_window_state
from .mesh import Mesh, make_mesh
from .tp import shard_params, sharded_fraction, tp_plan

DRYRUN_UNET = dict(block_out_channels=(16, 32, 32, 32), attention_head_dim=2,
                   cross_attention_dim=12, norm_num_groups=4, motion_num_attention_heads=2)
DRYRUN_CONFIG = {
    "num_inference_steps": 50, "t_index_list": [30, 40],
    "unet_additional_kwargs": {"motion_module_kwargs": {"num_attention_heads": 2}},
}


def stream_dtypes(device: torch.device) -> Tuple[torch.dtype, torch.dtype]:
    """(compute dtype, KV-cache dtype) of the dryruns on ``device``."""
    return (torch.float32, torch.float32) if device.type == "cpu" else (torch.bfloat16,
                                                                        torch.int8)


def cache_sharding(mesh: Mesh, caches: Sequence[KVCache], config: UNetConfig
                   ) -> Tuple[KVCache, ...]:
    """This tp rank's slab of unsharded ``[steps, 2, window, C, HW]`` caches
    (and ``[steps, 2, window, C]`` scales): the channels of its heads, the
    K/V its column-sharded ``to_k``/``to_v`` compute. Contiguous copies (the
    stream-attention kernel takes no strided view). Caches of motion
    modules that stay whole (``config.motion_tp``) come back whole."""
    split = config.motion_tp(mesh.tp)
    if split == 1:
        return tuple(caches)

    def slab(t):
        per = t.shape[3] // split
        return t.narrow(3, mesh.tp_rank * per, per).contiguous()

    return tuple(tuple(slab(t) for t in c) if isinstance(c, tuple) else slab(c) for c in caches)


def random_unet(config: UNetConfig, seed: int = 0, dtype: torch.dtype = torch.float32,
                device=None) -> UNet3DConditionModel:
    """The UNet with every parameter drawn N(0, 0.02^2) from ``seed`` on
    ``device`` (the same on every rank of one device type), as the JAX
    package's ``flagship_stream_tp_check`` fills its parameters
    (``live2diff_tpu/parallel/infer.py:147-156``) and the port's builder
    draws what no file holds: the zero-initialised output projections too,
    so that no path is a no-op.

    Not N(0, 1/fan_in): with those weights the full-width bf16 step
    amplifies rounding differences some 300-fold over its depth, so that
    two orderings of the same sums, each block within 6.4e-5 of the other,
    end 1.7-2.1e-2 apart (PERF.md §6; ``scripts/tp_probe.py``)."""
    device = resolve_device(device)
    with torch.device("meta"):
        unet = UNet3DConditionModel(config)
    unet = unet.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for p in unet.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    return channels_last_convs_(unet.to(dtype)).eval()


def stream_inputs(config: UNetConfig, latent: int, steps: int, frames: int, text_len: int,
                  seed: int = 1, dtype: torch.dtype = torch.float32, device=None) -> dict:
    """A stream's UNet inputs from ``seed`` (numpy): the warmup clip of 8
    latent frames and its depth, the prompt, the step timesteps, and each
    streamed frame's ``[steps, 1, latent, latent, 4]`` sample and depth."""
    rs = np.random.RandomState(seed)
    warm = (1, 8, latent, latent, 4)
    each = (frames, steps, 1, latent, latent, 4)
    draw = {"warm_sample": rs.randn(*warm), "warm_depth": 0.5 * rs.randn(*warm),
            "text": 0.5 * rs.randn(steps, text_len, config.cross_attention_dim),
            "sample": rs.randn(*each), "depth": 0.5 * rs.randn(*each)}
    out = {k: torch.from_numpy(v.astype(np.float32)).to(device=device, dtype=dtype)
           for k, v in draw.items()}
    out["timesteps"] = torch.arange(steps, 0, -1, device=device) * (1000 // (steps + 1)) - 1
    return out


@torch.no_grad()
def run_stream(unet: UNet3DConditionModel, caches: Sequence[KVCache], inputs: dict
               ) -> Tuple[List[torch.Tensor], Tuple[KVCache, ...], dict]:
    """The warmup, then every streamed frame through the window (the state
    machine advanced after each), eagerly. Returns the frames' outputs, the
    caches and, for each frame, its host ms (synchronised on the card) and
    the kernels it launched by wrapper (``_build.launch_counts``)."""
    cfg, t, caches = unet.config, inputs["timesteps"], tuple(caches)
    for idx in range(t.shape[0]):  # the warmup fills every step row's caches
        _, caches = unet(inputs["warm_sample"], t[idx:idx + 1], inputs["text"][:1],
                         inputs["warm_depth"], caches, "warmup", None, None, None, idx)
    device = inputs["sample"].device
    window = init_window_state(t.shape[0], cfg.window_size, cfg.sink_size, device=device)
    outs, ms, launches = [], [], []
    for sample, depth in zip(inputs["sample"], inputs["depth"]):
        before = dict(_build.launch_counts)
        t0 = time.perf_counter()
        out, caches = unet(sample, t, inputs["text"], depth, caches, "stream",
                           mask_to_bias(window[0]), window[1], window[2])
        update_window_state(*window, cfg.sink_size, out=window)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({k: v - before.get(k, 0) for k, v in _build.launch_counts.items()
                         if v != before.get(k, 0)})
        outs.append(out)
    return outs, caches, {"frame_ms": ms, "launches": launches}


def _rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).mean().sqrt() / (b ** 2).mean().sqrt())


def compare_caches(ours: Sequence[KVCache], ref: Sequence[KVCache]) -> dict:
    """This rank's caches against the unsharded caches' slabs: for int8
    caches the share of codes that differ and the largest difference (a
    code within rounding of a .5 boundary may take the next one), the
    scales' largest relative error and the dequantised caches' relative
    RMS; for float caches the largest error over the largest value."""
    codes = differ = worst = 0
    rel, sq_diff, sq_ref = 0.0, 0.0, 0.0
    for a, b in zip(ours, ref):
        if isinstance(a, tuple):
            d = (a[0].int() - b[0].int()).abs()
            codes += d.numel()
            differ += int((d > 0).sum())
            worst = max(worst, int(d.max()))
            rel = max(rel, float((a[1] - b[1]).abs().max() / b[1].abs().max()))
            da, db = (c[0].double() * c[1].double()[..., None] for c in (a, b))
            sq_diff += float((da - db).pow(2).sum())
            sq_ref += float(db.pow(2).sum())
        else:
            rel = max(rel, float((a.float() - b.float()).abs().max()
                                 / b.float().abs().max().clamp_min(1e-30)))
    if codes:
        return {"codes_differ_share": differ / codes, "max_code_diff": worst,
                "scales_max_rel_err": rel, "dequantised_rel_rms": (sq_diff / sq_ref) ** 0.5}
    return {"max_rel_err": rel}


def tp_stream_check(mesh: Mesh, config: UNetConfig, latent: int = 8, steps: int = 2,
                    frames: int = 1, text_len: int = 77, dtype: Optional[torch.dtype] = None,
                    cache_dtype: Optional[torch.dtype] = None, seed: int = 0,
                    device=None) -> dict:
    """The stream step of ``config`` (random weights from ``seed``, the same
    on every rank) unsharded and then cut over the mesh's tp ranks, on the
    same inputs: the warmup, then ``frames`` streamed frames. Returns a
    report: each frame's relative RMS error and largest error over the
    largest value, this rank's caches against the unsharded caches' slabs,
    the share of parameter bytes on tp, each run's frame ms and the sharded
    run's launches a frame."""
    device = resolve_device(device)
    default_dtype, default_cache = stream_dtypes(device)
    dtype, cache_dtype = dtype or default_dtype, cache_dtype or default_cache
    unet = random_unet(config, seed, dtype, device)
    inputs = stream_inputs(config, latent, steps, frames, text_len, seed + 1, dtype, device)
    caches = config.init_caches(latent, latent, steps, cache_dtype, device)
    ref, ref_caches, ref_run = run_stream(unet, caches, inputs)
    fraction = sharded_fraction(unet, tp_plan(unet, mesh.tp))
    shard_params(unet, mesh)
    caches = config.init_caches(latent, latent, steps, cache_dtype, device, tp=mesh.tp)
    outs, caches, run = run_stream(unet, caches, inputs)
    for o in outs:
        if not torch.isfinite(o).all():
            raise FloatingPointError("tp stream step: a non-finite output")
    return {
        "rel_rms": [_rel_rms(o, r) for o, r in zip(outs, ref)],
        "max_rel_err": [float((o.float() - r.float()).abs().max() / r.float().abs().max())
                        for o, r in zip(outs, ref)],
        "caches": compare_caches(caches, cache_sharding(mesh, ref_caches, config)),
        "param_bytes_on_tp": fraction,
        "frame_ms": run["frame_ms"], "unsharded_frame_ms": ref_run["frame_ms"],
        "launches": run["launches"], "output_mean": float(outs[-1].float().mean()),
    }


def stream_step_tp_dryrun(mesh: Optional[Mesh] = None, latent: int = 8, device=None) -> float:
    """Two tp-sharded stream steps of the tiny UNet after its warmup, the
    second through the caches the first wrote (``live2diff_tpu/parallel/
    infer.py:74-105``). Returns the output mean (finite, or it raises)."""
    mesh = mesh or make_mesh()
    device = resolve_device(device)
    dtype, cache_dtype = stream_dtypes(device)
    config = UNetConfig(**DRYRUN_UNET)
    unet = random_unet(config, 0, dtype, device)
    shard_params(unet, mesh)
    inputs = stream_inputs(config, latent, 2, 2, 7, 1, dtype, device)
    caches = config.init_caches(latent, latent, 2, cache_dtype, device, tp=mesh.tp)
    mean = float(run_stream(unet, caches, inputs)[0][-1].float().mean())
    if not np.isfinite(mean):
        raise FloatingPointError(f"tp stream step: output mean {mean}")
    return mean


def flagship_stream_tp_check(mesh: Optional[Mesh] = None, latent: int = 8, steps: int = 2,
                             tol: Optional[float] = None, device=None) -> float:
    """The full-width ``UNetConfig()`` stream step cut over tp against the
    unsharded step (``live2diff_tpu/parallel/infer.py:108-188``): asserts
    the relative error (largest error over the largest value) within
    ``tol`` (2e-4 in fp32 on the CPU, as the JAX check; 1e-2 at the card's
    bf16) and, at tp > 1, at least 60 % of the parameter bytes on tp.
    Returns the error."""
    mesh = mesh or make_mesh()
    device = resolve_device(device)
    tol = tol or (2e-4 if device.type == "cpu" else 1e-2)
    report = tp_stream_check(mesh, UNetConfig(), latent, steps, 1, device=device)
    if mesh.tp > 1 and report["param_bytes_on_tp"] < 0.60:
        raise AssertionError(f"tp rules degenerate at flagship shapes: only "
                             f"{report['param_bytes_on_tp']:.1%} of parameter bytes on tp")
    err = report["max_rel_err"][0]
    if not err < tol:
        raise AssertionError(f"flagship tp-sharded step diverges from unsharded: {err:.2e}")
    return err


def multi_session_run(mesh: Mesh, sessions: int, rounds: int = 2, latent: int = 8,
                      seed: int = 0, device=None, config: Optional[dict] = None,
                      **build_kw) -> Dict[str, np.ndarray]:
    """This dp rank's share of ``sessions`` streams (``sessions / dp`` of
    them, the global sessions ``dp_rank * S ... + S - 1``) in one
    ``MultiStream``: the pipeline of ``config`` (the dryruns' tiny one by
    default; ``build_kw`` passes to ``build_pipeline``) from ``seed``, each
    session warmed on its own frames and prompt from its own seed, then
    ``rounds`` rounds of uint8 frames. No collective. Returns this rank's
    outputs ``[rounds, S, H, W, 3]`` and its sessions' noised latents in
    flight."""
    from ..builder import build_pipeline
    from ..stream.multi import MultiStream

    device = resolve_device(device)
    if sessions % mesh.dp:
        raise ValueError(f"{sessions} sessions do not split over {mesh.dp} dp ranks")
    per = sessions // mesh.dp
    mine = slice(mesh.dp_rank * per, (mesh.dp_rank + 1) * per)
    dtype, cache_dtype = stream_dtypes(device)
    kw = dict(dtype=dtype, kv_cache_dtype=cache_dtype, seed=seed, device=device,
              unet_overrides=DRYRUN_UNET, use_depth=False, use_lcm_lora=False)
    kw.update(build_kw)
    size = latent * 8
    built = build_pipeline(config or DRYRUN_CONFIG, size, size, **kw)
    dim = built.unet.config.cross_attention_dim
    rs = np.random.RandomState(seed + 1)
    warm = rs.randint(0, 256, (sessions, 8, size, size, 3)).astype(np.uint8)[mine]
    prompts = rs.randn(sessions, 77, dim).astype(np.float32)[mine]
    frames = rs.randint(0, 256, (rounds, sessions, size, size, 3)).astype(np.uint8)[:, mine]
    multi = MultiStream(built.stream, per)
    states, _ = multi.prepare(torch.from_numpy(warm).to(device), torch.from_numpy(prompts),
                              seeds=[1000 + i for i in range(sessions)][mine])
    outs = []
    for frame in frames:
        states, out = multi(states, torch.from_numpy(frame).to(device))
        outs.append(out.cpu().numpy())
    return {"outputs": np.stack(outs), "x_t_buffer": states.x_t_buffer.float().cpu().numpy()}


def multi_session_dp_dryrun(mesh: Optional[Mesh] = None, sessions: Optional[int] = None,
                            latent: int = 8, device=None) -> float:
    """One dp-sharded multi-session round (``live2diff_tpu/parallel/
    infer.py:235-265``): each dp rank steps its sessions (``max(2, dp)``
    in all by default) in its own ``MultiStream``, with no collective.
    Returns the mean of this rank's outputs."""
    mesh = mesh or make_mesh(tp=1)
    s = sessions or max(2, mesh.dp)
    out = multi_session_run(mesh, s, rounds=1, latent=latent, device=device)["outputs"]
    if out.shape[1] != s // mesh.dp:
        raise AssertionError(f"{out.shape[1]} sessions on this rank, expected {s // mesh.dp}")
    return float(out.astype(np.float64).mean())


def dryrun_multichip(mesh: Optional[Mesh] = None, device=None) -> None:
    """Every multi-rank path once, as ``__graft_entry__.dryrun_multichip``
    runs the JAX package's, printing its lines: the train step and the tp
    stream step on ``mesh`` (the default split), the sessions over dp, and
    the full-width stream step cut over tp against the unsharded one. Every
    rank calls it."""
    from .train import train_step_dryrun

    mesh = mesh or make_mesh()
    n = mesh.world_size
    loss = train_step_dryrun(mesh, device=device)
    print(f"dryrun_multichip({n}): train step ok, loss={loss:.6f}")
    mean = stream_step_tp_dryrun(mesh, device=device)
    print(f"dryrun_multichip({n}): tp-sharded stream step ok, mean={mean:.6f}")
    mean = multi_session_dp_dryrun(make_mesh(tp=1), device=device)
    print(f"dryrun_multichip({n}): dp-sharded session step ok, mean={mean:.6f}")
    err = flagship_stream_tp_check(mesh, device=device)
    print(f"dryrun_multichip({n}): FLAGSHIP-SHAPES tp stream step ok, "
          f"rel err vs unsharded={err:.2e}")
