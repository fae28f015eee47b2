#!/usr/bin/env python3
"""``chip_smoke.py`` phase 18 alone, on one card.

    python3 scripts/phase18_alone.py

Builds the kernels, rebuilds the entries phase 18 extends (phase 2's stream
attention and d-major flash rows; phase 16's training pair at the 12 shapes
a phase 16 step logs), then runs ``tp_phase`` and prints its report, as the
whole script does after phase 16 (about 2.5 minutes with the build, against
about 10 for the whole script).
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# (q shape, k shape, scale): [forward calls, backward calls] of one phase 16 step
TRAIN_SHAPES = {
    ((8, 16, 8, 160), (8, 16, 8, 160), 0.0790569): [1, 1],
    ((8, 16, 8, 160), (8, 77, 8, 160), 0.0790569): [1, 1],
    ((8, 64, 8, 160), (8, 64, 8, 160), 0.0790569): [5, 5],
    ((8, 64, 8, 160), (8, 77, 8, 160), 0.0790569): [5, 5],
    ((8, 256, 8, 80), (8, 77, 8, 80), 0.111803): [5, 5],
    ((8, 256, 8, 80), (8, 256, 8, 80), 0.111803): [5, 5],
    ((8, 1024, 8, 40), (8, 77, 8, 40), 0.158114): [5, 4],
    ((8, 1024, 8, 40), (8, 1024, 8, 40), 0.158114): [5, 4],
    ((32, 4, 8, 160), (32, 4, 8, 160), 0.0790569): [10, 10],
    ((128, 4, 8, 160), (128, 4, 8, 160), 0.0790569): [10, 10],
    ((512, 4, 8, 80), (512, 4, 8, 80), 0.111803): [10, 10],
    ((2048, 4, 8, 40), (2048, 4, 8, 40), 0.158114): [10, 10],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("phase18_alone: needs a CUDA device", file=sys.stderr)
        return 2
    from live2diff_tpu_torch.ops import _build

    query = "--query-gpu=name,power.limit"
    smi = subprocess.run(["nvidia-smi", query, "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.strip().splitlines()[0])
    cs.SFU_RATE.append(cs.SFU_PER_SM_CLOCK * torch.cuda.get_device_properties(0)
                       .multi_processor_count * mhz * 1e6)
    print(smi)
    _build.build(_build.SOURCES)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    src = "live2diff_tpu_torch/csrc/"
    kernels = [
        cs.summarise("stream_attention_int8", src + "stream_attention.cu", "",
                     cs.check_stream_attention(torch, gen, dev, "int8")),
        cs.summarise("stream_attention_bf16", src + "stream_attention.cu", "",
                     cs.check_stream_attention(torch, gen, dev, "bf16")),
        cs.summarise("flash_attention", src + "flash_attention.cu", "",
                     cs.check_flash(torch, gen, dev)),
    ]
    fwd, bwd = cs.check_train_attention(torch, gen, dev, TRAIN_SHAPES)
    kernels += [dict(cs.summarise(name, src + "flash_train.cu", "", rows), per_what="training step")
                for name, rows in (("flash_train_fwd", fwd), ("flash_train_bwd", bwd))]
    t0 = time.perf_counter()
    cs.report_tp_phase(cs.tp_phase(torch, gen, dev, kernels, TRAIN_SHAPES, smi), smi)
    print(f"phase 18 alone: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
