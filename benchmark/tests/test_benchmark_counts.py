"""The work counts and the trace arithmetic against hand counts, on the CPU."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import harness  # noqa: E402
import tracemath as tr  # noqa: E402
import work  # noqa: E402
from reference import models as ref_models  # noqa: E402
from reference import stream as ref_stream  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import bench_tiny_cell  # noqa: E402

TINY_DPT = dict(image_size=64, patch_grid=4, vit_hidden=32, vit_layers=2, vit_heads=2,
                vit_mlp=64, hooks=[0, 1], resnet_layers=[1, 1, 1],
                stage_channels=[128, 256, 512], reassemble_channels=32, features=32)


# Each shipped configuration's parameters, (model, name, shape) in the order
# the weights are drawn, and each cell's work counts: (model FLOPs a call,
# digest of the flash and the stream attention calls). Frozen, since the
# same seed must keep giving every cell the same weights, reference frames
# and readings.
SHAPES = {
    "sd15-live2diff-demo":
        (1716, "4d7214ecdce27ffa4806f1f50001dcc9eab1059dfbcf1324a9748a94ad44b0bd"),
    "sd15-live2diff-toonyou":
        (1716, "4d7214ecdce27ffa4806f1f50001dcc9eab1059dfbcf1324a9748a94ad44b0bd"),
}
WORK = {
    "demo-512-1stream":
        (2872027942912.0, "cd6e6baeee053070d12d784d18dc6a30e3ca2884c272372e246508c7211e0f5d"),
    "toonyou-512-1stream":
        (5099190259712.0, "6fcd4633cfa422df8a511ddd24b68bbf7ee30883c23bcff6462c4442aa18e6ae"),
    "demo-512-4sessions":
        (11477200027648.0, "3d2abdc03e5715ee2e9329ee86e29f76cea0c3cc4c63e89f069359d2b827491a"),
    "demo-768x512-1stream":
        (4359343149056.0, "93c2932b3571532b8865b8436e6cc0713b022e7663d9073029a172bdb3c761c8"),
}

# a configuration's own reference module: a small codec with a one-head
# attention, a mean of moments, quant convs and a latent scale inside its
# encode and decode, and the work counts of its own models
OWN_CODEC = '''
import torch
from torch import nn

from . import models as base

SCALE = 0.18215


class Codec(nn.Module):
    def __init__(self, c):
        super().__init__()
        hid, lat = c["hidden"], c["latent_channels"]
        self.down = nn.ModuleList([base.Conv(cin, hid, 3, stride=2, padding=1)
                                   for cin in (3, hid, hid)])
        self.qkv = base.Lin(hid, 3 * hid)
        self.moments = base.Conv(hid, 2 * lat, 3, padding=1)
        self.quant_conv = base.Conv(2 * lat, 2 * lat, 1)
        self.post_quant_conv = base.Conv(lat, lat, 1)
        self.conv_in = base.Conv(lat, hid, 3, padding=1)
        self.conv_out = base.Conv(hid, 3, 3, padding=1)

    def encode(self, x):
        for conv in self.down:
            x = torch.relu(conv(x))
        q, k, v = self.qkv(x.reshape(x.shape[0], -1, x.shape[-1])).chunk(3, dim=-1)
        x = x + base.attention(q[:, :, None], k[:, :, None], v[:, :, None]).reshape(x.shape)
        mean, _ = self.quant_conv(self.moments(x)).chunk(2, dim=-1)
        return mean * SCALE

    def decode(self, z):
        x = torch.relu(self.conv_in(self.post_quant_conv(z / SCALE)))
        return self.conv_out(x.repeat_interleave(8, dim=1).repeat_interleave(8, dim=2))


def models(cfg):
    return {"unet": base.UNet(cfg["unet"]), "vae": Codec(cfg["codec"])}


def codec_flops(cfg, height, width, encodes, decodes):
    hid, lat = cfg["codec"]["hidden"], cfg["codec"]["latent_channels"]
    h, w = height // 8, width // 8
    enc = sum(2 * cin * hid * 9 * (height >> i) * (width >> i)
              for i, cin in ((1, 3), (2, hid), (3, hid)))
    enc += 2 * h * w * hid * 3 * hid + 4 * (h * w) ** 2 * hid
    enc += 2 * hid * 2 * lat * 9 * h * w + 2 * (2 * lat) ** 2 * h * w
    dec = 2 * lat * lat * h * w + 2 * lat * hid * 9 * h * w + 2 * hid * 3 * 9 * height * width
    return float(encodes * enc + decodes * dec)


def flash_attention_calls(cfg, traffic):
    n = (2 if cfg["use_depth"] else 1) * traffic["sessions"]
    s = (traffic["height"] // 8) * (traffic["width"] // 8)
    c = cfg["codec"]["hidden"]
    return [(4.0 * n * s * s * c, 4.0 * n * s * c * 2)]
'''


def digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()


def counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def filled(cfg):
    modules = ref_stream.build(cfg, "cpu")
    for m in modules.values():
        for p in m.parameters():
            torch.nn.init.normal_(p, 0.0, 0.05)
    return modules


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_shipped_configurations_keep_their_parameters(name):
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"] if c["name"] == name)
    shapes = ref_stream.shapes(json.loads((BENCH.parent / entry["file"]).read_text()))
    assert (len(shapes), digest(shapes)) == SHAPES[name]


@pytest.mark.parametrize("cell", sorted(WORK))
def test_shipped_cells_keep_their_work_counts(cell):
    found, _ = harness.find_cell(BENCH.parent, cell)
    cfg, traffic = found.cfg, found.traffic
    calls = [work.flash_attention_calls(cfg, traffic), work.stream_attention_calls(cfg, traffic)]
    assert (work.model_flops(cfg, traffic), digest(calls)) == WORK[cell]


def test_a_configuration_module_brings_its_own_work_counts(tmp_path):
    """A configuration naming its own reference module: the model FLOPs
    count the module's codec as a counter does over its encode and decode,
    its attention call is added to the flash calls, and the stream calls,
    which it does not report, stay the UNet's."""
    path = tmp_path / "own_codec.py"
    path.write_text(OWN_CODEC)
    plain = bench_tiny_cell.tiny_config()
    cfg = dict(plain, reference=str(path), codec={"hidden": 16, "latent_channels": 4})
    traffic = {"sessions": 1, "height": 32, "width": 48}
    vae = filled(cfg)["vae"]
    enc = counted(lambda: vae.encode(torch.rand(1, 32, 48, 3)))
    dec = counted(lambda: vae.decode(torch.rand(1, 4, 6, 4)))
    rows = len(cfg["t_index_list"])
    assert work.model_flops(cfg, traffic) == work.unet_flops(cfg["unet"], 4, 6, rows) + enc + dec
    assert work.flash_attention_calls(cfg, traffic) == (
        work.flash_attention_calls(plain, traffic) + [(4.0 * 24 * 24 * 16, 4.0 * 24 * 16 * 2)])
    assert work.stream_attention_calls(cfg, traffic) == work.stream_attention_calls(plain, traffic)


@pytest.mark.parametrize("rows,hw", [(2, (16, 16)), (4, (16, 24))])
def test_unet_flops_match_a_counter_over_the_reference(rows, hw):
    cfg = bench_tiny_cell.tiny_config()
    unet = filled(cfg)["unet"]
    lh, lw = hw
    u = cfg["unet"]
    dims = ref_models.level_dims(lh, lw, len(u["block_out_channels"]))
    caches = [ref_models.Cache(rows, u["window_size"], dims[lv][0] * dims[lv][1], c, False, "cpu")
              for c, lv in unet.motion_channels()]
    window = ref_stream.init_window(rows, u["window_size"], u["sink_size"], "cpu")
    x = torch.randn(rows, 1, lh, lw, 4)
    ctx = torch.randn(rows, 77, u["cross_attention_dim"])
    got = counted(lambda: unet(x, torch.tensor([100] * rows), ctx, x, caches, "stream", window))
    assert work.unet_flops(u, lh, lw, rows) == got


def test_dpt_and_taesd_flops_match_a_counter():
    cfg = bench_tiny_cell.tiny_config()
    cfg.update(use_depth=True, dpt=TINY_DPT)
    modules = filled(cfg)
    img = torch.rand(1, 64, 64, 3)
    assert work.dpt_flops(TINY_DPT, 1) == counted(lambda: modules["depth"](img))
    enc = counted(lambda: modules["vae"].encoder(torch.rand(2, 32, 48, 3)))
    dec = counted(lambda: modules["vae"].decoder(torch.rand(1, 4, 6, 4)))
    assert work.taesd_flops(cfg["taesd"], 32, 48, 2, 1) == enc + dec


def test_attention_work_by_hand():
    """A UNet of two levels at an 8x8 latent: a spatial block and a motion
    module (two temporal attentions) at level 0, none at level 1 but the
    mid block's spatial block at 4x4, and the up block's at 8x8."""
    cfg = bench_tiny_cell.tiny_config(kv="int8")
    cfg["unet"].update(block_out_channels=[8, 16], layers_per_block=1,
                       down_block_types=["CrossAttnDownBlock3D", "DownBlock3D"],
                       up_block_types=["UpBlock3D", "CrossAttnUpBlock3D"],
                       motion_module_resolutions=[1])
    cfg.update(t_index_list=[10, 20, 30], use_depth=True,
               dpt=dict(TINY_DPT, patch_grid=2, vit_hidden=16, vit_layers=3))
    traffic = {"sessions": 2, "height": 64, "width": 64}
    rows, w = 6, 16  # 2 sessions x 3 steps; the window
    # motion modules: down level 0 (1 layer), up level 0 (2 layers); 2 attentions each
    flops = 4 * rows * 64 * w * 8
    nbytes = 2 * rows * 64 * 8 * 2 + 2 * rows * w * 8 * 64 * 1 + 2 * rows * w * 8 * 4
    assert work.stream_attention_calls(cfg, traffic) == [(flops, nbytes)] * 6
    # spatial: down level 0 (64 tokens, C 8), mid (16 tokens, C 16), up level 0 x2
    want = []
    for hw, c in ((64, 8), (16, 16), (64, 8), (64, 8)):
        want += [(4 * rows * hw * hw * c, 4 * rows * hw * c * 2),
                 (4 * rows * hw * 77 * c, 2 * rows * (hw + 77) * c * 2)]
    want += [(4 * 2 * 5 * 5 * 16, 4 * 2 * 5 * 16 * 2)] * 3  # the ViT: 2x2 + 1 tokens, 2 images
    assert work.flash_attention_calls(cfg, traffic) == want
    assert work.least_seconds([(10.0, 100.0), (50.0, 1.0)], 10.0, 10.0) == 10.0 + 5.0


EVENTS = [  # name, start us, duration us, by a graph replay
    ("void at::native::elementwise_kernel<128, 2, f>(int, f)", 0.0, 10.0, True),
    ("nvjet_tst_128x8_64x12_2x1_v_bz_TNT", 5.0, 10.0, True),  # overlaps the first
    ("void {anonymous}::stream_attention_kernel<__nv_bfloat16, 4>(P)", 30.0, 5.0, True),
    ("Memcpy DtoH (Device -> Pageable)", 40.0, 2.0, False),
    ("void fsm90::flash_sm90_kernel<128, false, false>(F)", 50.0, 4.0, True),
]


def test_union_gaps_buckets_by_hand():
    assert tr.union_us(EVENTS) == 15.0 + 5.0 + 2.0 + 4.0
    assert tr.idle_gaps(EVENTS, 0.0, 60.0) == [(15.0, 30.0), (35.0, 40.0), (42.0, 50.0),
                                               (54.0, 60.0)]
    assert [tr.bucket(e[0]) for e in EVENTS] == [
        tr.ELEMENTWISE, tr.GEMMS, "#2 stream_attention_bf16", tr.ELEMENTWISE,
        "#3 flash_attention (d-major)"]
    assert tr.family("void at::native::f<4, g<h>>(int)") == "at::native::f"
    gaps = [(15.0, 30.0), (35.0, 40.0)]
    host = [("outer", 0.0, 100.0), ("cudaDeviceSynchronize", 10.0, 32.0)]
    assert tr.label_gaps(gaps, host) == [["cudaDeviceSynchronize", 15e-6], ["outer", 5e-6]]


def test_assign_by_correlation():
    device = [(1, "k1", 5.0, 1.0), (2, "k2", 30.0, 1.0), (3, "k3", 31.0, 1.0)]
    runtime = [(1, "cudaGraphLaunch", 1.0), (2, "cudaLaunchKernel", 21.0), (3, "cudaMemcpy", 50.0)]
    calls, unassigned = tr.assign_by_correlation(device, runtime, [(0.0, 10.0), (20.0, 25.0)])
    assert calls == [[("k1", 5.0, 1.0, True)], [("k2", 30.0, 1.0, False)]]
    assert unassigned == ["k3"]


def reader(name):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def context(calls, peaks=None, fps=10.0, window_us=100.0):
    cfg = json.loads((BENCH / "configs/sd15-live2diff-demo.json").read_text())
    traffic = json.loads((BENCH / "workloads/camera-512-1stream.json").read_text())
    flat = [e for c in calls for e in c]
    return harness.TraceContext(calls=calls, window_us=window_us, busy_us=tr.union_us(flat),
                                fps=fps, cfg=cfg, traffic=traffic, peaks=peaks)


def test_readers_by_hand():
    other = [(n, s + 100.0, d, g) for n, s, d, g in EVENTS]
    calls = [EVENTS, other, EVENTS[:2]]
    ctx = context(calls, window_us=200.0)
    assert reader("device_idle_pct")(ctx) == pytest.approx(100 * (1 - 2 * 26.0 / 200.0))
    assert reader("kernels_per_frame")(ctx) == 4.0  # the copy is not a kernel
    assert reader("elementwise_ms")(ctx) == pytest.approx(12e-3)  # median of 12, 12, 10 us
    assert reader("gemm_ms")(ctx) == pytest.approx(10e-3)
    assert reader("stream_attn_roofline_pct")(ctx) is None  # no peaks for this card
    assert reader("mfu_pct")(ctx) is None
    peaks = {"bf16_flops": 1e15, "hbm_bytes": 1e12}
    ctx = context(calls, peaks=peaks, fps=20.0)
    least = work.least_seconds(work.stream_attention_calls(ctx.cfg, ctx.traffic), 1e15, 1e12)
    assert reader("stream_attn_roofline_pct")(ctx) == pytest.approx(100 * least / 5e-6)
    least = work.least_seconds(work.flash_attention_calls(ctx.cfg, ctx.traffic), 1e15, 1e12)
    assert reader("flash_attn_roofline_pct")(ctx) == pytest.approx(100 * least / 4e-6)
    flops = work.model_flops(ctx.cfg, ctx.traffic)
    assert reader("mfu_pct")(ctx) == pytest.approx(100 * flops * 20.0 / 1e15)
    # a reader that finds nothing to read returns nothing, never 0
    empty = context([[EVENTS[0]]], peaks=peaks)
    assert reader("stream_attn_roofline_pct")(empty) is None
    assert reader("flash_attn_roofline_pct")(empty) is None
