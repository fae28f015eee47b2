"""The start-up split of a cold and a warm start: the port's counterpart of
``tools/aot_probe.py``.

    python -m live2diff_tpu_torch.tools.aot_probe prime [--engine-dir engines]
    python -m live2diff_tpu_torch.tools.aot_probe load  [--engine-dir engines]
        [--height 512 --width 512] [--kv-cache int8] [--spatial-qk bf16|int8]
        [--steps 30 40] [--tiny] [--device cuda|cpu]

``prime`` builds bench.py's default pipeline (512x512, TAESD, DPT-hybrid,
int8 KV cache, bf16 spatial QK, uint8 frames, random weights) through
``StreamV2VWrapper`` and writes its kernel libraries into the engine
directory (``prime_aot``), building them first where they are not built.
``load``, in a fresh process, builds the same wrapper, which loads them
from there (``aot_hit``), then runs ``prepare`` on 8 frames and one frame.
Each prints one JSON line: ``build_s`` (the wrapper's construction less
the load), ``aot_load_s`` (the checks, the loads and the validating
step), ``prepare_s`` (warmup, the eager warm step, the capture), and
``first_step_s``, ``total_to_first_frame_s`` (from the start of this
script) and ``aot_hit``. On a miss ``prepare_s`` holds the ``nvcc`` builds.

``--spatial-qk`` picks the flash variant of the gated self-attentions
(``bf16``: the d-major kernel, the port bench's default; ``int8``: the
int8-QK kernel) and ``--steps`` the ``t_index_list``, as in
``tools/aot_probe.py``, whose ``--spatial-qk`` defaults to ``int8``. Its
``--no-xla-cache`` has no counterpart: it turns off JAX's persistent XLA
compilation cache, and the port compiles no XLA program.
"""

from __future__ import annotations

import argparse
import json
import time

_T0 = time.perf_counter()


def _wrapper(args):
    from ..wrapper import StreamV2VWrapper
    from ._common import FLASH_VARIANT, TINY_SIZE, TINY_UNET, bench_config, tiny_dtype

    kw = dict(height=args.height, width=args.width, kv_cache_dtype=args.kv_cache,
              use_depth=not args.tiny, flash_variant=FLASH_VARIANT[args.spatial_qk])
    if args.tiny:
        import torch

        kw.update(height=TINY_SIZE, width=TINY_SIZE, unet_overrides=TINY_UNET,
                  dtype=tiny_dtype(torch.device(args.device)))
    return StreamV2VWrapper(bench_config(args.steps), output_type="np", use_text_encoder=False,
                            engine_dir=args.engine_dir, device=args.device, seed=0,
                            **kw)


def prime(args) -> dict:
    """Build the wrapper and prime the engine directory; returns the times."""
    t0 = time.perf_counter()
    wrapper = _wrapper(args)
    out = {"phase": "prime", "build_s": time.perf_counter() - t0, "aot_hit": wrapper.aot_hit}
    t0 = time.perf_counter()
    out["primed"] = wrapper.prime_aot()
    out["prime_s"] = time.perf_counter() - t0
    return out


def load(args) -> dict:
    """Build the wrapper (loading from the engine directory where it is
    primed), prepare it and stream one frame; returns the split."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    wrapper = _wrapper(args)
    aot_s = getattr(wrapper.stream, "_aot_load_s", 0.0) if wrapper.aot_hit else 0.0
    out = {"phase": "load", "build_s": time.perf_counter() - t0 - aot_s, "aot_load_s": aot_s,
           "aot_hit": wrapper.aot_hit}
    rng = np.random.RandomState(0)
    h, w = wrapper.height, wrapper.width
    t0 = time.perf_counter()
    wrapper.prepare("probe", rng.randint(0, 256, (8, h, w, 3)).astype(np.uint8))
    out["prepare_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wrapper(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    if wrapper.device.type == "cuda":
        torch.cuda.synchronize(wrapper.device)
    out["first_step_s"] = time.perf_counter() - t0
    out["total_to_first_frame_s"] = time.perf_counter() - _T0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="aot_probe", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("phase", choices=["prime", "load"])
    p.add_argument("--engine-dir", default="engines")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--kv-cache", default="int8")
    p.add_argument("--spatial-qk", choices=["bf16", "int8"], default="bf16",
                   help="flash variant of the gated self-attentions: bf16 (d-major) or int8")
    p.add_argument("--steps", type=int, nargs="*", default=[30, 40], help="t_index_list")
    p.add_argument("--tiny", action="store_true", help="64x64, a narrow UNet, no depth model")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    print(json.dumps((prime if args.phase == "prime" else load)(args)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
