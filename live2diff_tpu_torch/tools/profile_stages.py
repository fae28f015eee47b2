"""Where the frame's time goes, stage by stage: the port's counterpart of
``tools/profile_stages.py``.

    python -m live2diff_tpu_torch.tools.profile_stages [--height 512] [--width 512]
        [--steps 30 40] [--skip-unet] [--trace DIR] [--tiny] [--device cuda|cpu]

Builds bench.py's pipeline (512x512, TAESD, DPT-hybrid, int8 KV cache,
uint8 frames, random weights), prepares it on 8 frames and times each stage
of the step alone: the codec's encode of the frame and its depth image, the
depth branch (``_depth_image``: resize, DPT, normalisation, resize back),
the stream-batch UNet call on a scratch state, and the decode. Then the
step itself, as it streams (one replay of the captured step a frame), and
the sums JAX's tool prints: the codecs' sum and the implied UNet and state
work (step minus codecs).

On the card each stage is captured alone in a CUDA graph, as the step is
(the counterpart of the JAX tool jitting each stage alone), warmed 3 times
and timed over 20 replays with CUDA events; so is the step. On the CPU
(``--device cpu``) the stages run eagerly on the host clock: CPU timings,
not a device measurement. ``--trace DIR`` writes a Chrome trace of 3 steps
(``utils/timing.profile_trace``).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Optional, Tuple

import torch

ITERS, WARMUP = 20, 3


def _timed_ms(fn: Callable[[], object], device: torch.device, iters: int, warmup: int) -> float:
    """Mean ms a call of ``fn`` (no arguments, static inputs): on CUDA one
    graph of it, captured after ``warmup`` eager calls on a side stream and
    replayed ``iters`` times between two events; on the CPU eager calls on
    the host clock."""
    if device.type != "cuda":
        for _ in range(warmup):
            fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters

    from ..stream.graph import capture_graph

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph, _, _ = capture_graph(fn, (), pool=None)
    try:
        graph.replay()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            graph.replay()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    finally:
        graph.reset()


def _step_ms(stream, state, frame, iters: int, warmup: int):
    """Mean ms a streamed frame (a replay of the captured step on CUDA),
    after ``warmup`` frames; returns (state, ms)."""
    for _ in range(warmup):
        state, _ = stream(state, frame)
    cuda = stream.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(stream.device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        state, _ = stream(state, frame)
    if cuda:
        end.record()
        torch.cuda.synchronize(stream.device)
        return state, start.elapsed_time(end) / iters
    return state, (time.perf_counter() - t0) * 1e3 / iters


@torch.no_grad()
def profile_stages(stream, state, frame: torch.Tensor, iters: int = ITERS, warmup: int = WARMUP,
                   skip_unet: bool = False, trace_dir: Optional[str] = None
                   ) -> Tuple[object, Dict[str, float]]:
    """Each stage of ``stream``'s step timed alone, then the step streaming
    ``frame`` (``[H, W, 3]``) from ``state``. Returns the advanced state and
    {stage: ms}, with ``codecs_sum``, ``sum`` (with the UNet), ``step``,
    ``fps`` and ``implied_unet_and_state``."""
    from ..stream.state_machine import mask_to_bias
    from ..utils.timing import profile_trace

    dev, dt, n = stream.device, stream.dtype, stream.num_steps
    cfg = stream.cfg
    lh, lw = cfg.latent_height, cfg.latent_width
    gen = torch.Generator(device=dev).manual_seed(0)
    rgb = frame.float()[None] / 127.5 - 1.0 if frame.dtype == torch.uint8 else frame.float()[None]
    depth = stream.depth_model is not None
    # the step encodes the frame and its depth image in one batch
    enc_in = torch.cat([rgb, rgb] if depth else [rgb]).to(dt).contiguous()
    x_t = torch.randn((n, 1, lh, lw, 4), generator=gen, device=dev).to(dt)
    d_lat = torch.randn((n, 1, lh, lw, 4), generator=gen, device=dev).to(dt)
    x0 = torch.randn((1, lh, lw, 4), generator=gen, device=dev)

    stages = {f"vae_encode x{enc_in.shape[0]}": lambda: stream.vae.encode(enc_in),
              "vae_decode": lambda: stream._decode_latents(x0)}
    if depth:
        stages["depth (_depth_image)"] = lambda: stream._depth_image(rgb)
    ms = {name: _timed_ms(fn, dev, iters, warmup) for name, fn in stages.items()}
    codecs = sum(ms.values())
    if not skip_unet:
        scratch = stream.init_state(seed=0)
        bias = mask_to_bias(scratch.attn_mask)
        ms[f"unet x{n}"] = _timed_ms(
            lambda: stream.unet(x_t, stream.sub_timesteps, stream._prompt_embeds, d_lat,
                                scratch.kv_caches, "stream", bias, scratch.pe_idx,
                                scratch.update_idx)[0],
            dev, iters, warmup)
        del scratch
    state, step = _step_ms(stream, state, frame, iters, warmup)
    ms.update(codecs_sum=codecs, step=step, fps=1e3 / step, implied_unet_and_state=step - codecs)
    if not skip_unet:
        ms["sum"] = codecs + ms[f"unet x{n}"]
    if trace_dir:
        with profile_trace(trace_dir):
            for _ in range(3):
                state, _ = stream(state, frame)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    return state, ms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="profile_stages", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--steps", type=int, nargs="*", default=[30, 40])
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a Chrome trace of 3 steps into DIR")
    p.add_argument("--skip-unet", action="store_true",
                   help="skip the UNet alone; read its cost as the step minus the codecs")
    p.add_argument("--tiny", action="store_true", help="64x64, a narrow UNet, no depth model")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ._common import build_bench_pipeline, card_line, inputs

    built = build_bench_pipeline(args.device, args.height, args.width, args.steps,
                                 tiny=args.tiny)
    stream = built.stream
    prompt, warm, clip = inputs(stream, 1)
    state, _ = stream.prepare(warm[0], prompt, seed=2)
    state, ms = profile_stages(stream, state, clip[0, 0], skip_unet=args.skip_unet,
                               trace_dir=args.trace)
    cfg = stream.cfg
    print(f"stage timings ({cfg.width}x{cfg.height}, {stream.num_steps} steps, {stream.dtype}, "
          f"{type(stream.vae).__name__}, depth {stream.depth_model is not None}; "
          f"{card_line(stream.device)}):")
    for name, v in ms.items():
        print(f"  {name:24s}: {v:9.3f}" + ("" if name == "fps" else " ms"))
    print(json.dumps(ms))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
