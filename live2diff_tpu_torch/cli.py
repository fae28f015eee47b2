"""Offline video-to-video CLI of the port.

Usage:
    python -m live2diff_tpu_torch.cli <video> <config.yaml> [--prompt ...]
        [--height 512] [--width 512] [--max-frames N] [--output out.gif]
        [--num-inference-steps N] [--t-index-list 30 40] [--strength S]
        [--kv-cache int8|bf16] [--device cuda|cpu]
        [--tiny] (a tiny random-weight model, for hosts without weights)

Port of ``live2diff_tpu/cli.py``, with its flags: decodes the input (a
video file, a GIF or a folder of numbered frames), warms up on the first 8
frames, streams the rest and writes the output video and a timing report
(EMA, mean and std). It runs on the card unless ``--device cpu`` is given;
``--tiny`` does not pick the device. Reading and writing images needs
Pillow, and video files imageio.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="live2diff-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("video", help="input video file, GIF, or frame directory")
    p.add_argument("config", help="style config YAML")
    p.add_argument("--prompt", default="", help="subject prompt, inserted into the "
                   "config's prompt template")
    p.add_argument("--output", default=None)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--max-frames", type=int, default=-1)
    p.add_argument("--num-inference-steps", type=int, default=None)
    p.add_argument("--t-index-list", type=int, nargs="*", default=None)
    p.add_argument("--strength", type=float, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--fps", type=int, default=16)
    p.add_argument("--no-depth", action="store_true")
    p.add_argument("--no-tiny-vae", action="store_true")
    p.add_argument("--kv-cache", choices=["bf16", "int8"], default=None,
                   help="KV-cache storage (int8: half the memory and bandwidth)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random-weight model, 64x64, fp32 (smoke/demo mode)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, where the kernels' plain versions run")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    from .utils.image import frames_to_uint8
    from .utils.io import read_video_frames, write_video
    from .wrapper import WARMUP_FRAMES, StreamV2VWrapper

    max_frames = None if args.max_frames in (-1, None) else args.max_frames
    frames = read_video_frames(args.video, max_frames)
    if len(frames) <= WARMUP_FRAMES:
        print(f"need more than {WARMUP_FRAMES} frames, got {len(frames)}", file=sys.stderr)
        return 2

    kwargs = {}
    if args.tiny:
        args.height = args.width = 64
        kwargs["unet_overrides"] = dict(
            block_out_channels=(8, 16, 16, 16), attention_head_dim=2,
            norm_num_groups=4, motion_num_attention_heads=2,
        )
        kwargs["dtype"] = "float32"
    if args.kv_cache:
        kwargs["kv_cache_dtype"] = args.kv_cache

    stream = StreamV2VWrapper(
        args.config,
        num_inference_steps=args.num_inference_steps,
        t_index_list=args.t_index_list,
        strength=args.strength,
        height=args.height,
        width=args.width,
        use_tiny_vae=not args.no_tiny_vae,
        use_depth=not args.no_depth and not args.tiny,
        output_type="pt",
        seed=args.seed,
        device=args.device,
        **kwargs,
    )

    print(f"warmup on {WARMUP_FRAMES} frames...", file=sys.stderr)
    stream.prepare(args.prompt, frames[:WARMUP_FRAMES])

    outputs = []
    lag = stream.batch_size - 1  # outputs lag inputs by the stream batch
    for i, frame in enumerate(frames[WARMUP_FRAMES:]):
        out = stream(frame)
        if i >= lag:  # the first `lag` outputs replay the buffers' start
            outputs.append(out * 2.0 - 1.0)
        print(f"\rframe {i + 1}/{len(frames) - WARMUP_FRAMES} "
              f"ema={stream.inference_time_ema*1000:.1f}ms", end="", file=sys.stderr)
    print(file=sys.stderr)

    out_path = args.output or (os.path.splitext(args.video)[0] + "_out.gif")
    if outputs:
        write_video(out_path, frames_to_uint8(outputs), fps=args.fps)

    t = stream.timing_summary()
    print(f"frames={len(outputs)} fps={t['fps']:.2f} "
          f"mean={t['mean_s']*1000:.1f}±{t['std_s']*1000:.1f}ms "
          f"ema={t['ema_s']*1000:.1f}ms -> {out_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
