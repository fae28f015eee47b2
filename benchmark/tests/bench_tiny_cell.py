"""A tiny cell for rehearsals on the host: a copy of the benchmark under a
temporary root, with one narrow configuration (the program's plain path on
the CPU), a 64x64 traffic file and a check file added as new files."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_UNET = dict(block_out_channels=[32, 64, 64, 64], attention_head_dim=2, norm_num_groups=8,
                 motion_num_attention_heads=2)
TINY_TRAFFIC = {"entry": "wrapper", "sessions": 1, "height": 64, "width": 64,
                "pool_frames": 8, "setup_calls": 2, "trace_calls": 2,
                "pattern": {"gratings": 2, "period_px": [8, 32], "speed_px": [0.5, 2.0],
                            "discs": 1, "disc_radius_px": [4, 12], "noise_std": 6.0}}


def tiny_config(dtype: str = "float32", kv: str = "fp32") -> dict:
    cfg = json.loads((REPO / "benchmark/configs/sd15-live2diff-demo.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg.update(name="tiny", dtype=dtype, kv_cache_dtype=kv, use_depth=False,
               reduced=sorted(TINY_UNET))
    cfg["unet"].update(TINY_UNET)
    return cfg


def make_root(tmp: Path, cfg: dict = None, traffic: dict = None, cell: str = "tiny-64",
              compare_calls: int = 10, limit=None, sessions: int = 1) -> Path:
    """``tmp`` as a checkout root: BENCHMARK.json and benchmark/ copied,
    then the tiny configuration, traffic and check added as files of their
    own and BENCHMARK.json given their entries."""
    root = tmp / "root"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = cfg or tiny_config()
    traffic = dict(traffic or TINY_TRAFFIC)
    if sessions > 1:
        traffic.update(entry="multistream", sessions=sessions)
    (root / "benchmark/configs/tiny.json").write_text(json.dumps(cfg))
    (root / f"benchmark/workloads/{cell}.json").write_text(json.dumps(traffic))
    (root / f"benchmark/checks/{cell}.json").write_text(json.dumps(
        {"compare_calls": compare_calls, "limits": {"frame_rms_max": limit}}))
    spec["configs"].append({"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json",
                            "reduced": cfg["reduced"], "why": "rehearsal"})
    spec["workloads"].append({"name": cell, "config": "tiny", "traffic": cell, "chips": 1,
                              "why": "rehearsal"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
