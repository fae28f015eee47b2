"""Output parity: weights dir and reference frames -> PSNR. The port's
counterpart of ``tools/parity.py``.

    python -m live2diff_tpu_torch.tools.parity <input-video> <config.yaml> \\
        --reference <reference-output-video-or-frame-dir> \\
        [--weights-dir /path/to/models-root] [--require-weights] \\
        [--prompt ...] [--height 512 --width 512] [--output ours] \\
        [--tiny] [--device cuda|cpu]

Builds ``StreamV2VWrapper`` from the style config (paths relative to
``--weights-dir``), streams the input as the CLI does (8 warmup frames,
then one output a frame, the first ``steps - 1`` outputs dropped for the
stream batch's lag) and prints one JSON line: the PSNR of the output
against the reference frames, the missing weight artifacts and the card's
name and power limit. ``--require-weights`` exits 3 when any artifact is
missing; without it the missing ones run with random weights, and a
comparison against this tool's own earlier output (``--output`` to a path
without extension writes a PNG folder) must give inf. ``--tiny`` is a
64x64 pipeline with a narrow UNet and no depth model (fp32 on the CPU,
bf16 on the card). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="parity", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("video", help="input video file, GIF, or frame directory")
    p.add_argument("config", help="style config YAML")
    p.add_argument("--reference", default=None,
                   help="reference output video or frame dir to score against; omit to only "
                   "run the pipeline and report missing weights")
    p.add_argument("--weights-dir", default=None,
                   help="directory the config's relative model paths resolve against")
    p.add_argument("--require-weights", action="store_true",
                   help="fail (exit 3) if any weight artifact is missing")
    p.add_argument("--prompt", default="")
    p.add_argument("--output", default=None, help="also write our output video")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-depth", action="store_true")
    p.add_argument("--no-tiny-vae", action="store_true")
    p.add_argument("--kv-cache", choices=["bf16", "int8"], default=None)
    p.add_argument("--tiny", action="store_true",
                   help="64x64, a narrow UNet, no depth model (a plumbing check)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, where the kernels' plain versions run")
    return p


def run(args) -> dict:
    """Build, stream, score. Returns the result dict (also printed)."""
    import torch

    from ..builder import resolve_device
    from ..utils.image import frames_to_uint8
    from ..utils.io import read_video_frames, write_video
    from ..wrapper import WARMUP_FRAMES, StreamV2VWrapper
    from ._common import TINY_SIZE, TINY_UNET, card_line, tiny_dtype
    from .psnr import score

    device = resolve_device(args.device)
    config = os.path.abspath(args.config)
    reference = os.path.abspath(args.reference) if args.reference else None
    output = os.path.abspath(args.output) if args.output else None

    frames = read_video_frames(os.path.abspath(args.video), args.max_frames)
    if len(frames) <= WARMUP_FRAMES:
        raise SystemExit(f"need more than {WARMUP_FRAMES} frames, got {len(frames)}")

    kwargs = {}
    if args.tiny:
        args.height = args.width = TINY_SIZE
        kwargs.update(unet_overrides=TINY_UNET, dtype=tiny_dtype(device))
    if args.kv_cache:
        kwargs["kv_cache_dtype"] = args.kv_cache

    cwd = os.getcwd()
    if args.weights_dir:
        os.chdir(args.weights_dir)  # config paths are relative to the models root
    try:
        wrapper = StreamV2VWrapper(
            config, height=args.height, width=args.width, use_tiny_vae=not args.no_tiny_vae,
            use_depth=not args.no_depth and not args.tiny, output_type="pt", seed=args.seed,
            device=device, **kwargs)
    finally:
        os.chdir(cwd)

    missing = list(wrapper.built.missing_artifacts)
    if args.require_weights and missing:
        print(json.dumps({"error": "missing weight artifacts", "missing": missing}))
        raise SystemExit(3)

    lag = wrapper.batch_size - 1
    if len(frames) - WARMUP_FRAMES <= lag:
        raise SystemExit(f"need more than {WARMUP_FRAMES + lag} frames for an output "
                         f"({WARMUP_FRAMES} warmup, a lag of {lag}), got {len(frames)}")
    wrapper.prepare(args.prompt, frames[:WARMUP_FRAMES])
    outputs = []
    for i, frame in enumerate(frames[WARMUP_FRAMES:]):
        out = wrapper(frame)
        if i >= lag:
            outputs.append(out * 2.0 - 1.0)
    ours = frames_to_uint8(outputs)
    if output:
        write_video(output, ours, fps=16)

    result = {"metric": "psnr_vs_reference", "unit": "dB", "frames": len(ours),
              "missing_artifacts": len(missing), "device": card_line(device),
              "torch": torch.__version__}
    if missing:
        result["missing_sample"] = missing[:4]
    if reference:
        scored = score(ours, read_video_frames(reference, args.max_frames))
        result.update(value=scored["value"], per_frame_min=scored["per_frame_min"],
                      scored_frames=scored["frames"])
    else:
        result["value"] = None
    print(json.dumps(result))
    return result


def main(argv=None) -> int:
    run(build_argparser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
