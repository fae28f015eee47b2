"""The port's measuring tools (live2diff_tpu_torch/tools/, utils/timing.py)
on the CPU, against the JAX package's where there is one.

* ``psnr`` against ``tools/psnr.py:psnr`` (loaded by path) on random uint8
  frames, and inf on equal frames.
* ``parity`` at ``--tiny --device cpu`` against its own earlier output: inf
  (8 warmup frames, the config's 4 steps' lag of 3, 3 outputs).
* ``trace_step``'s aggregation (families, buckets, gaps) and its frames
  by correlation id, on synthetic events with known answers.
* ``profile_stages``, ``trace_step`` and ``aot_probe load`` run once each at
  ``--tiny --device cpu``; ``profile_trace`` writes a Chrome trace.
"""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from live2diff_tpu_torch.tools import aot_probe, parity, profile_stages, psnr, trace_step
from live2diff_tpu_torch.utils.timing import profile_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"_jax_tools_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_psnr_matches_jax():
    jax_psnr = _jax_tool("psnr").psnr
    rng = np.random.RandomState(0)
    for _ in range(4):
        a = rng.randint(0, 256, (3, 32, 48, 3)).astype(np.uint8)
        b = np.clip(a.astype(np.int16) + rng.randint(-9, 10, a.shape), 0, 255).astype(np.uint8)
        assert abs(psnr.psnr(a, b) - jax_psnr(a, b)) <= 1e-12
        assert abs(psnr.psnr(a, b, peak=1.0) - jax_psnr(a, b, peak=1.0)) <= 1e-12
    assert psnr.psnr(a, a) == float("inf") == jax_psnr(a, a)
    scored = psnr.score([a[0], a[1]], [a[0], b[1], b[2]])
    assert scored["frames"] == 2 and scored["value"] == float("inf")
    assert scored["per_frame_min"] == round(psnr.psnr(a[1], b[1]), 2)
    with pytest.raises(ValueError):
        psnr.score([], [a[0]])


def _frame_folder(path, n, seed=0):
    from PIL import Image

    path.mkdir()
    rng = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)).save(
            path / f"{i:03d}.png")
    return path


def test_parity_tiny_self_comparison_is_inf(tmp_path, capsys):
    pytest.importorskip("PIL")
    video = _frame_folder(tmp_path / "in", 14)
    config = os.path.join(REPO, "configs", "toonyou.yaml")  # 4 steps: a lag of 3
    out = tmp_path / "ours"  # no extension: a lossless PNG folder
    first = parity.run(parity.build_argparser().parse_args(
        [str(video), config, "--tiny", "--device", "cpu", "--seed", "7", "--output", str(out)]))
    assert first["frames"] == 3 and first["value"] is None and first["missing_artifacts"] > 0
    assert first["device"].startswith("cpu")
    second = parity.run(parity.build_argparser().parse_args(
        [str(video), config, "--tiny", "--device", "cpu", "--seed", "7",
         "--reference", str(out)]))
    assert second["scored_frames"] == 3 and second["value"] == float("inf")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["value"] == float("inf")
    with pytest.raises(SystemExit) as e:
        parity.run(parity.build_argparser().parse_args(
            [str(video), config, "--tiny", "--device", "cpu", "--require-weights"]))
    assert e.value.code == 3


# ---------------------------------------------------------------------------
# trace_step's aggregation on synthetic events
# ---------------------------------------------------------------------------

FLASH = "void flash_sm90_kernel<64, false, false>(Params, CUtensorMap)"
CONV = "void conv3x3_sm90<1, 64>(ConvParams)"
GEMM = "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT"
ADD = ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<c10::"
       "BFloat16>, std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<c10::BFloat16>, "
       "std::array<char*, 3ul>)")
ADD_F32 = ADD.replace("BFloat16", "float")
REDUCE = ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >"
          "(at::native::ReduceOp<float>)")


def test_trace_step_aggregates_known_events():
    # two frames; in each: flash 0-100, gemm 110-160, conv 160-190 (busy
    # 180 of a 190 span), two adds, a reduce, all launched by a graph replay
    frame = [(FLASH, 0.0, 100.0), (GEMM, 110.0, 50.0), (CONV, 160.0, 30.0),
             (ADD, 20.0, 5.0), (ADD_F32, 30.0, 5.0), (REDUCE, 40.0, 10.0)]
    frames = [[(n, t + off, d, True) for n, t, d in frame] for off in (0.0, 1000.0)]
    r = trace_step.aggregate(frames, wall_ms=[0.3, 0.25, 0.2], top=5)
    assert r["frames"] == 2 and r["kernels"] == 6
    assert r["kernels_by_frame"] == [6, 6] and r["unassigned"] == 0
    assert r["kernels_full"] == 6 and r["dropped_by_frame"] == {}
    assert r["device_ms"] == pytest.approx(0.2)
    assert list(r["top"])[:4] == [FLASH, GEMM, CONV, REDUCE] and len(r["top"]) == 5
    assert r["top"][FLASH] == pytest.approx([0.1, 1.0])
    fam = r["families"]
    assert fam["flash_sm90_kernel"] == pytest.approx([0.1, 1.0])
    assert fam["at::native::vectorized_elementwise_kernel"] == pytest.approx([0.01, 2.0])
    b = r["buckets"]
    assert b["#3 flash_attention (d-major)"] == pytest.approx([0.1, 1.0])
    assert b["#6 conv3x3"] == pytest.approx([0.03, 1.0])
    assert b["cuBLAS GEMMs"] == pytest.approx([0.05, 1.0])
    assert b["elementwise and copies"] == pytest.approx([0.01, 2.0])
    assert b["other"] == pytest.approx([0.01, 1.0])
    g = r["gaps"]
    assert g["span_ms"] == pytest.approx([0.19, 0.19])
    assert g["busy_ms"] == pytest.approx([0.18, 0.18])
    assert g["idle_in_span_ms_p50"] == pytest.approx(0.01)
    assert g["host_ms"] == pytest.approx(0.25 - 0.19)
    assert g["launch_ms_p50"] is None and g["before_replay_ms_p50"] is None
    # per frame: gaps of 10 us (flash -> gemm) and 0 (gemm -> conv, and the
    # three short events inside the flash)
    assert g["between_events"] == {"<1us": pytest.approx([4.0, 0.0]),
                                   "<20us": pytest.approx([1.0, 0.01])}
    assert g["widest"][:2] == [[10.0, FLASH, GEMM]] * 2 and g["widest"][2][0] == 0.0
    # replays timed without the profiler: (host before, host inside, device
    # span); the span is theirs, and a copy before the replay is not busy time
    copy = ("Memcpy DtoD (Device -> Device)", -30.0, 20.0, False)
    replays = [(0.05, 0.02, 0.2), (0.04, 0.03, 0.22), (0.06, 0.01, 0.21)]
    r = trace_step.aggregate([[copy] + frames[0], frames[1]], [0.3, 0.25, 0.2], 5, replays, 3)
    g = r["gaps"]
    assert r["kernels_by_frame"] == [7, 6] and r["unassigned"] == 3
    # frame 1 holds no copy: against the fullest frame, the trace dropped it
    assert r["kernels_full"] == 7 and r["dropped_by_frame"] == {1: {copy[0]: 1}}
    assert g["span_ms_p50"] == pytest.approx(0.21) and g["busy_ms"] == pytest.approx([0.18] * 2)
    assert g["idle_in_span_ms_p50"] == pytest.approx(0.03)
    assert g["host_ms"] == pytest.approx(0.04)
    assert g["before_replay_ms_p50"] == pytest.approx(0.05)
    assert g["launch_ms_p50"] == pytest.approx(0.02)
    assert g["profiled_span_ms_p50"] == pytest.approx((0.22 + 0.19) / 2)


def test_trace_step_assigns_records_by_correlation():
    # frame 0's host range is 0-100 us, frame 1's 100-200; frame 0's graph
    # ran late: its last kernel starts at 130 on the device, inside frame
    # 1's host range, and still belongs to frame 0
    windows = [(0.0, 100.0), (100.0, 200.0)]
    runtime = [(11, "cudaMemcpyAsync", 5.0), (12, "cudaGraphLaunch", 10.0),
               (21, "cudaGraphLaunch", 110.0), (30, "cudaGraphLaunch", 250.0)]
    device = [(11, "copy", 6.0, 1.0), (12, "a", 20.0, 50.0), (12, "b", 130.0, 10.0),
              (21, "a", 150.0, 30.0), (21, "b", 181.0, 10.0), (30, "a", 260.0, 1.0),
              (99, "orphan", 50.0, 1.0)]
    frames, unassigned = trace_step.assign_by_correlation(device, runtime, windows)
    assert frames == [[("copy", 6.0, 1.0, False), ("a", 20.0, 50.0, True),
                       ("b", 130.0, 10.0, True)],
                      [("a", 150.0, 30.0, True), ("b", 181.0, 10.0, True)]]
    assert unassigned == ["a", "orphan"]  # launched outside every frame, or by no call
    assert trace_step.RUNTIME_CALL.match("cudaGraphLaunch")
    assert trace_step.RUNTIME_CALL.match("cuLaunchKernelEx")
    assert not trace_step.RUNTIME_CALL.match("cutlass::Kernel")


def test_trace_step_family_and_bucket_names():
    assert trace_step.family(
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::(anonymous "
        "namespace)::OpaqueType<2u>, unsigned int, 4, 64, 64>(at::native::(anonymous namespace)"
        "::OpaqueType<2u>*, unsigned int)") == "at::native::{anonymous}::CatArrayBatchedCopy"
    assert trace_step.family("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"
    cases = {"void stream_attention_kernel<signed char, 4, true>(P)": "#1 stream_attention_int8",
             "void stream_attention_kernel<__nv_bfloat16, 4, true>(P)": "#2 stream_attention_bf16",
             "void flash_sm90_kernel<64, true, true>(P)": "#5 flash_attention_int8",
             "void quantise_kernel(QParams)": "#5 flash_attention_int8",
             "void conv3x3_sm90<2, 64>(P)": "#7 conv3x3_s2",
             "void layer_norm_kernel<8>(P)": "#9 layer_norm",
             "void group_norm_kernel<true>(P)": "#8 group_norm",
             "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_cudnn":
                 "cuDNN convs",
             "Memset (Device)": "elementwise and copies"}
    for name, label in cases.items():
        assert trace_step.bucket(name) == label, name


# ---------------------------------------------------------------------------
# the tools end to end, tiny, on the CPU
# ---------------------------------------------------------------------------

def test_profile_stages_tiny_cpu(capsys):
    assert profile_stages.main(["--tiny", "--device", "cpu"]) == 0
    ms = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(ms) == {"vae_encode x1", "vae_decode", "unet x2", "codecs_sum", "sum", "step",
                       "fps", "implied_unet_and_state"}
    assert all(v > 0 for k, v in ms.items() if k != "implied_unet_and_state")
    assert ms["codecs_sum"] == pytest.approx(ms["vae_encode x1"] + ms["vae_decode"])


def test_trace_step_tiny_cpu(tmp_path, capsys):
    assert trace_step.main(["--tiny", "--device", "cpu", "--frames", "2", "--top", "5",
                            "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["frames"] == 2 and summary["kernels"] > 100 and summary["device_ms"] > 0
    assert summary["measured_on"].startswith("cpu")
    assert len(summary["gaps"]["span_ms"]) == 2
    assert "coarse buckets" in out and "aten::" in out
    assert [f for f in os.listdir(tmp_path) if f.endswith(".json")]


def test_aot_probe_load_tiny_cpu(tmp_path, capsys):
    assert aot_probe.main(["load", "--tiny", "--device", "cpu",
                           "--engine-dir", str(tmp_path)]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["aot_hit"] is False and r["aot_load_s"] == 0.0
    assert r["total_to_first_frame_s"] >= r["prepare_s"] + r["first_step_s"] > 0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(None) as prof:
        assert prof is None
    with profile_trace(str(tmp_path / "t")) as prof:
        torch.ones(8).add_(1)
    (trace,) = os.listdir(tmp_path / "t")
    assert trace.endswith(".json") and "traceEvents" in json.load(open(tmp_path / "t" / trace))
