"""What the kernel scripts share: the card's description, cold-call timing
(by events, or the kernels' own device time by the profiler), and copies of
a CUDA source with text edits built with the port's flags.

Imported by ``scripts/kernel_ab.py``, ``scripts/conv_probe.py`` and
``scripts/stream_probe.py`` (their directory is first on ``sys.path`` when
they run).
"""

from __future__ import annotations

import ctypes
import os
import subprocess


def nvidia_smi(query: str) -> str:
    """The first card's line of ``nvidia-smi --query-gpu=QUERY``."""
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return nvidia_smi("name,power.limit")


def max_sm_mhz() -> float:
    """The card's max SM clock in MHz (clock64() counts at it)."""
    return float(nvidia_smi("clocks.max.sm").split()[0])


def cold_timer(torch, reps: int):
    """``time_ms(fn)``: the mean device ms of ``fn()`` over ``reps`` calls
    after one warm-up call, with CUDA events, the L2 cache overwritten
    (512 MB) before each call outside its events, as ``chip_smoke.py``
    times a kernel: the card stays busy longer than the host takes to
    launch the call, so the host's time does not count."""
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")

    def time_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(reps):
            flush.fill_(1)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / reps

    return time_ms


def device_timer(torch, reps: int):
    """``time_ms(fn)``: the mean device ms per call of the kernels ``fn()``
    launches, from a torch.profiler trace of ``reps`` calls, each after the
    same L2 overwrite as ``cold_timer`` (whose fill kernel is left out): the
    kernels' own time, without the launch gaps that events count. A trace
    whose kernel records are not a whole number a call (the profiler drops
    a record now and then) is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")

    def time_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    flush.fill_(1)
                    fn()
                torch.cuda.synchronize()
            us, count = 0.0, 0
            for e in prof.key_averages():
                if e.device_type != torch.autograd.DeviceType.CUDA or "FillFunctor" in e.key:
                    continue
                t = getattr(e, "self_device_time_total", None)
                us += e.self_cuda_time_total if t is None else t
                count += e.count
            if count and count % reps == 0:
                return us / 1e3 / reps
        raise RuntimeError("the profiler lost kernel records in three traces running")

    return time_ms


def patched(text: str, edits, what: str) -> str:
    """``text`` with each (anchor, replacement) of ``edits`` applied; every
    anchor must occur exactly once."""
    for anchor, new in edits:
        if text.count(anchor) != 1:
            raise RuntimeError(f"{what}: anchor not found once: {anchor[:60]!r}")
        text = text.replace(anchor, new)
    return text


def build_copies(text: str, variants, out_dir: str, prefix: str):
    """Build a copy of the CUDA source ``text`` for each (name, edits) of
    ``variants``, one nvcc each with the port's flags, all in parallel,
    under ``out_dir``. Returns {name: the loaded library}."""
    from live2diff_tpu_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        src = os.path.join(out_dir, f"{prefix}_{i}.cu")
        with open(src, "w") as f:
            f.write(patched(text, edits, f"{prefix} ({name})"))
        lib = src[:-3] + ".so"
        procs[name] = lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {prefix} ({name}):\n{out}")
        libs[name] = ctypes.CDLL(lib)
    return libs
