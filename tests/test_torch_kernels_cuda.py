"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA Hopper GPU and ``nvcc``; without a CUDA device each
test skips. They complement ``chip_smoke.py`` (which checks the production
shapes of the 512x512 stream step) with ragged shapes: lengths that are not
multiples of the kernels' tiles, every head width the flash kernel takes,
channel counts that take the conv kernel's scalar load path, LayerNorm at
every lanes-a-row instance (8, 16 and 32 lanes, C = 328 that cannot fill its
lanes, a block a row at C = 2048, 2560) and at row counts that take its
grid-stride loop, both cache dtypes of
stream attention at every production level of both rows and at ragged
ones, on each of its routes (TMA or element staging, with and without a
cluster), with only the sink visible, and over repeated cold launches
that must agree bit for bit, the s-major and int8-QK flash entries on
strided ``[B, H, S, D]`` views at lengths that are not multiples of their
tiles (the bf16 flash entries: 128 query rows, 128 keys or 64 at D > 128),
the int8-QK entry's pre-pass against ``quantize_groups`` bit for bit,
repeated cold launches of the int8-QK and LayerNorm kernels bit-equal,
the int8 KV cache's quantisation against the CPU, GroupNorm at ragged row
counts with each activation, at C = 4096 with 512 groups, C / G < 8, its
widest row and its streamed route, over repeated cold launches that must
agree bit for bit, as one device kernel a call and replayed from a CUDA
graph, the conv at the edges of its 4 x 16 output
tiles, on both input paths, with a skip aligned to 4 bytes only and over
repeated launches on inputs evicted from the L2, and the wrappers'
refusals. Run them on the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX, which this file does not
use.) Tolerances are relative to the plain version's largest value: the
kernels round the same bf16 operands at other points (probabilities, the
dequantised cache) and sum in another order, ~2^-8 relative at worst;
LayerNorm rounds its output to bf16 once (2^-9). The s-major and int8-QK
entries round p from the same logits against the same block max as their
plain versions, so they are also held to a relative RMS error far below
what leaving out the int8 quantisation changes (~1e-2).
"""

from __future__ import annotations

from collections import Counter

import pytest
import torch

from live2diff_tpu_torch.ops import _build
from live2diff_tpu_torch.ops.attention import dot_product_attention, stream_window_attention
from live2diff_tpu_torch.ops.conv import conv3x3, conv3x3_plain
from live2diff_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_plain, flash_self_attention, flash_self_attention_int8,
    flash_self_attention_int8_plain, flash_self_attention_plain, pick_block, quantize_groups,
    quantize_groups_cuda,
)
from live2diff_tpu_torch.ops.choices import KernelChoices
from live2diff_tpu_torch.ops.norm import (
    gn_device_limits, gn_route_counts, group_norm, group_norm_act, group_norm_plain,
    group_norm_plan, layer_norm, layer_norm_plain, layer_norm_rows,
)
from live2diff_tpu_torch.ops.stream_attention import (
    stream_window_attention_bf16, stream_window_attention_int8, stream_window_attention_plain,
)

pytestmark = pytest.mark.cuda

ATTN_TOL = 2e-2
CONV_TOL = 1e-2
LN_TOL = 1e-2
GN_TOL = 1e-2  # one bf16 rounding of the output, as LayerNorm
VARIANT_RMS_TOL = 1e-3  # only the order of fp32 sums differs
INT8_TOL = 8e-3  # below the int8-vs-bf16 Q.K gap (chip_smoke.py measures it)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False  # full-fp32 plain references
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(out, ref) -> float:
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _rms(out, ref) -> float:
    d = out.float() - ref.float()
    return (d.pow(2).mean().sqrt() / ref.float().pow(2).mean().sqrt()).item()


def _randn(gen, dev, *shape):
    return torch.randn(*shape, generator=gen, device=dev)


@pytest.mark.parametrize("b,sq,sk,h,d", [
    (1, 100, 77, 3, 40),   # ragged query tile, cross-attention length
    (2, 64, 64, 2, 8),     # smallest head width (padded to 16)
    (1, 65, 130, 2, 80),   # one row past a tile, ragged key tiles
    (3, 8, 8, 8, 160),     # warmup motion attention: S = 8
    (1, 1, 5, 1, 24),
    (2, 200, 200, 4, 64),
    (1, 33, 129, 2, 96),
    (1, 50, 50, 1, 128),
])
def test_flash_attention_matches_plain(dev, b, sq, sk, h, d):
    gen = torch.Generator(device=dev).manual_seed(sq * 1000 + d)
    q = _randn(gen, dev, b, sq, h, d).to(torch.bfloat16)
    k = _randn(gen, dev, b, sk, h, d).to(torch.bfloat16)
    v = _randn(gen, dev, b, sk, h, d).to(torch.bfloat16)
    before = _build.launch_counts["flash_attention"]
    out = flash_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention"] == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert _rel(out, flash_attention_plain(q, k, v, d ** -0.5)) < ATTN_TOL


# the edges of the 128-row query tile and of the key tiles (128 keys; 64 at
# D > 128), every head-width chunking (D padded to 64, 128, 192), and the
# warmup motion attention's B * H = 4096 * 8 at S = 8
@pytest.mark.parametrize("b,sq,sk,h,d", [
    *[(1, sq, sk, 2, 40) for sq in (127, 129, 257) for sk in (77, 129, 255)],
    *[(1, 129, 255, 2, d) for d in (8, 24, 40, 64, 80, 96, 128, 160)],
    (1, 257, 129, 2, 160), (2, 127, 77, 3, 160),
    (4096, 8, 8, 8, 40),
])
def test_flash_attention_tile_edges(dev, b, sq, sk, h, d):
    test_flash_attention_matches_plain(dev, b, sq, sk, h, d)


def _strided_bhsd(gen, dev, b, s, h, d, pad):
    """A [B, H, S, D] view of [B, S, H, D] rows whose batch stride is pad
    elements longer than S * H * D."""
    base = _randn(gen, dev, b, s * h * d + pad).to(torch.bfloat16)
    return base.as_strided((b, h, s, d), (s * h * d + pad, d, h * d, 1))


@pytest.mark.parametrize("b,h,s,d,block_q,block_k,pad", [
    (1, 2, 1536, 40, 512, 768, 0),    # 768x512's second level, two blocks
    (1, 2, 1536, 80, 512, 768, 0),
    (1, 2, 1000, 80, 1024, 1024, 0),  # one block ending inside a key tile
    (1, 2, 300, 160, 512, 1024, 0),   # 64-key tiles, the block ends inside one
    (2, 2, 384, 40, 128, 128, 64),    # batch stride S * H * D + 64
    (2, 3, 257, 96, 512, 1024, 8),
])
def test_flash_smajor_tile_edges(dev, b, h, s, d, block_q, block_k, pad):
    gen = torch.Generator(device=dev).manual_seed(s * 10 + d + pad)
    q, k, v = (_strided_bhsd(gen, dev, b, s, h, d, pad) for _ in range(3))
    before = _build.launch_counts["flash_attention_smajor"]
    out = flash_self_attention(q, k, v, d ** -0.5, block_q, block_k)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention_smajor"] == before + 1
    ref = flash_self_attention_plain(q, k, v, d ** -0.5, block_q, block_k)
    assert _rel(out, ref) < ATTN_TOL
    assert _rms(out, ref) < VARIANT_RMS_TOL


# a negative scale takes the row minimum of the raw scores, a zero scale
# gives uniform weights: the kernels take m = max(s * c) either way
@pytest.mark.parametrize("scale", [-0.3, 0.0])
def test_flash_entries_take_any_scale(dev, scale):
    gen = torch.Generator(device=dev).manual_seed(17)
    q, k, v = (_randn(gen, dev, 1, 300, 2, 40).to(torch.bfloat16) for _ in range(3))
    ref = flash_attention_plain(q, k, v, scale)
    assert _rel(flash_attention(q, k, v, scale), ref) < ATTN_TOL
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out = flash_self_attention(qt, kt, vt, scale, 512, 1024)
    assert _rel(out, flash_self_attention_plain(qt, kt, vt, scale, 512, 1024)) < ATTN_TOL


# the int8 KV cache's [steps, HW, C] writes at 512x512, one per UNet level
@pytest.mark.parametrize("c,hw", [(320, 4096), (640, 1024), (1280, 256), (1280, 64)])
def test_quantize_kv_matches_cpu(dev, c, hw):
    from live2diff_tpu_torch.models.motion import _quantize_kv

    gen = torch.Generator().manual_seed(c + hw)
    x = (torch.randn(2, hw, c, generator=gen) * torch.rand(1, 1, c, generator=gen) * 4
         ).to(torch.bfloat16)
    codes, scales = _quantize_kv(x.to(dev), 1)
    codes_cpu, scales_cpu = _quantize_kv(x, 1)
    assert torch.equal(scales.cpu(), scales_cpu)
    assert torch.equal(codes.cpu(), codes_cpu)


@pytest.mark.parametrize("b,h,w,cin,stride,bias,skip,relu", [
    (1, 37, 45, 3, 1, True, False, True),     # RGB input, ragged tiles
    (2, 20, 70, 64, 1, True, True, True),
    (1, 9, 33, 16, 1, False, False, False),
    (1, 11, 13, 5, 1, True, True, False),     # scalar load path (Cin % 8 != 0)
    (1, 16, 24, 40, 1, True, False, True),    # Cin padded to 48
    (1, 38, 46, 64, 2, False, False, False),  # encoder downsample, ragged
    (2, 64, 96, 8, 2, True, True, True),
    # widths that are no multiple of the 16-pixel tile row (nor of 32)
    (1, 9, 45, 64, 1, True, True, True),
    (1, 7, 70, 64, 1, True, False, False),
    (2, 5, 97, 64, 1, False, True, True),
    (1, 6, 130, 16, 1, True, True, True),
    # 1, 2 and 3 rows: a 4-row tile mostly past the image
    (1, 1, 40, 64, 1, True, True, True),
    (2, 2, 33, 64, 1, True, False, True),
    (1, 3, 50, 8, 1, False, True, False),
    # Cin on the TMA path (Cin % 8 == 0) and on the staged path
    (1, 12, 36, 8, 1, True, True, True),
    (1, 12, 36, 16, 1, True, True, True),
    (1, 12, 36, 40, 1, True, True, True),
    (1, 12, 36, 64, 1, True, True, True),
    (2, 10, 20, 3, 1, True, True, True),
    (1, 10, 20, 5, 1, False, False, True),
    (1, 10, 20, 12, 1, True, True, False),
    # stride 2 with an odd output width, on both paths
    (2, 6, 38, 64, 2, True, True, True),
    (1, 10, 102, 64, 2, False, False, False),
    (1, 8, 102, 3, 2, True, False, True),
    (16, 64, 64, 64, 1, True, True, True),    # B = 16
    # 768x512's 64x96 and 128x192 levels
    (2, 64, 96, 64, 1, True, True, True),
    (1, 128, 192, 64, 1, True, True, True),
])
def test_conv3x3_matches_plain(dev, b, h, w, cin, stride, bias, skip, relu):
    gen = torch.Generator(device=dev).manual_seed(h * 100 + cin)
    x = _randn(gen, dev, b, h, w, cin).to(torch.bfloat16)
    wt = (_randn(gen, dev, 64, cin, 3, 3) / (9 * cin) ** 0.5).to(torch.bfloat16)
    bs = _randn(gen, dev, 64).to(torch.bfloat16) if bias else None
    sk = _randn(gen, dev, b, h // stride, w // stride, 64).to(torch.bfloat16) if skip else None
    _check_conv(x, wt, bs, sk, relu, stride)


def _check_conv(x, wt, bs, sk, relu, stride):
    b, h, w, _ = x.shape
    name = "conv3x3" if stride == 1 else "conv3x3_s2"
    before = _build.launch_counts[name]
    out = conv3x3(x, wt, bs, sk, relu, stride)
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 1
    ref = conv3x3_plain(x, wt, bs, sk, relu, stride)
    assert out.shape == ref.shape == (b, h // stride, w // stride, 64)
    assert _rel(out, ref) < CONV_TOL
    return out


def test_conv3x3_takes_a_4_byte_aligned_skip(dev):
    """A skip whose data starts 2 bf16 (4 bytes) into its storage: no
    16-byte alignment, which the wrapper does not ask of a skip."""
    gen = torch.Generator(device=dev).manual_seed(11)
    x = _randn(gen, dev, 2, 20, 36, 64).to(torch.bfloat16)
    wt = (_randn(gen, dev, 64, 64, 3, 3) / 24).to(torch.bfloat16)
    bs = _randn(gen, dev, 64).to(torch.bfloat16)
    base = _randn(gen, dev, 2 * 20 * 36 * 64 + 2).to(torch.bfloat16)
    sk = base[2:].view(2, 20, 36, 64)
    assert sk.data_ptr() % 16 == 4
    _check_conv(x, wt, bs, sk, True, 1)


@pytest.mark.parametrize("cin,stride", [(64, 2), (64, 1), (3, 2)])
def test_conv3x3_repeated_cold_launches_agree(dev, cin, stride):
    """200 launches, each on inputs evicted from the L2, bit-equal: copies
    that land out of order must not let a consumer or producer wait pass
    an mbarrier phase early (a 3-stage ring did at stride 2). At 512^2 a
    CTA takes 15 or more jobs, so each stage comes round several times."""
    gen = torch.Generator(device=dev).manual_seed(13)
    x = _randn(gen, dev, 2, 512, 512, cin).to(torch.bfloat16)
    wt = (_randn(gen, dev, 64, cin, 3, 3) / (9 * cin) ** 0.5).to(torch.bfloat16)
    bs = _randn(gen, dev, 64).to(torch.bfloat16)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    first = conv3x3(x, wt, bs, stride=stride)
    differ = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(200):
        flush.fill_(1)
        differ += (conv3x3(x, wt, bs, stride=stride) != first).any()
    assert differ.item() == 0
    assert _rel(first, conv3x3_plain(x, wt, bs, stride=stride)) < CONV_TOL


def test_conv3x3_calls_leave_no_state(dev):
    """The same module weights twice, with other shapes and Cin between:
    bit-equal outputs."""
    from live2diff_tpu_torch.models.vae import FusedConv3x3

    gen = torch.Generator(device=dev).manual_seed(12)
    conv = FusedConv3x3(64, 64, relu=True).to(dev, torch.bfloat16)
    x = _randn(gen, dev, 2, 40, 48, 64).to(torch.bfloat16)
    sk = _randn(gen, dev, 2, 40, 48, 64).to(torch.bfloat16)
    with torch.no_grad():
        first = conv(x, sk)
        conv3x3(_randn(gen, dev, 1, 16, 16, 3).to(torch.bfloat16),
                _randn(gen, dev, 64, 3, 3, 3).to(torch.bfloat16))
        conv3x3(_randn(gen, dev, 2, 32, 32, 64).to(torch.bfloat16), conv.weight, stride=2)
        second = conv(x, sk)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# every production level of the 512x512 and 768x512 steps (2 steps, 8
# heads), then ragged shapes: position tiles cut by HW (100, 33, 7 and the
# odd latent levels 96 and 24 of tests/test_torch_nonsquare.py), channel
# strides that take the element-load staging route, heads cut into 8-channel
# chunks over clusters
STREAM_SHAPES = [
    (2, 4096, 320, 8), (2, 1024, 640, 8), (2, 256, 1280, 8), (2, 64, 1280, 8),
    (2, 6144, 320, 8), (2, 1536, 640, 8), (2, 384, 1280, 8), (2, 96, 1280, 8),
    (2, 100, 320, 8), (1, 33, 64, 2), (3, 7, 16, 1), (2, 96, 320, 8), (2, 24, 320, 8),
    (1, 24, 1280, 8), (2, 200, 48, 2), (2, 100, 8, 1), (1, 40, 36, 3),
]


def _stream_args(dev, cache, s, hw, c, heads, visible, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = _randn(gen, dev, s, hw, c).to(torch.bfloat16)
    extra = _randn(gen, dev, s, 16, heads, hw)
    extra[:, visible:] = float("-inf")  # slots not yet visible; the sink always is
    pe_v = _randn(gen, dev, s, 16, c)
    scale = (c // heads) ** -0.5
    if cache == "int8":
        data = torch.randint(-127, 128, (s, 2, 16, c, hw), generator=gen, device=dev,
                             dtype=torch.int8)
        scales = 0.002 + 0.02 * torch.rand(s, 2, 16, c, generator=gen, device=dev)
        return (q, data, scales, extra, pe_v, scale, heads), (q, data, scales, extra, pe_v,
                                                               scale, heads)
    data = _randn(gen, dev, s, 2, 16, c, hw).to(torch.bfloat16)
    return (q, data, extra, pe_v, scale, heads), (q, data, None, extra, pe_v, scale, heads)


def _check_stream(dev, cache, s, hw, c, heads, visible=10):
    """One launch of the entry, on the route plan() gives the shape, within
    ATTN_TOL of the plain version."""
    from live2diff_tpu_torch.ops import stream_attention as sa

    args, plain_args = _stream_args(dev, cache, s, hw, c, heads, visible, hw * 10 + c)
    kernel = stream_window_attention_int8 if cache == "int8" else stream_window_attention_bf16
    name = f"stream_attention_{cache}"
    staging, cluster = sa.plan(s, hw, c, heads, 1 if cache == "int8" else 2,
                               torch.cuda.get_device_properties(dev).multi_processor_count)
    before, routes = _build.launch_counts[name], dict(sa.route_counts)
    out = kernel(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 1
    assert sa.route_counts[staging] == routes[staging] + 1
    assert sa.route_counts["cluster"] == routes["cluster"] + (cluster > 1)
    assert out.shape == (s, hw, c) and out.dtype == torch.bfloat16
    assert _rel(out, stream_window_attention_plain(*plain_args)) < ATTN_TOL
    return staging, cluster


@pytest.mark.parametrize("s,hw,c,heads", STREAM_SHAPES)
def test_stream_attention_int8_matches_plain(dev, s, hw, c, heads):
    _check_stream(dev, "int8", s, hw, c, heads)


@pytest.mark.parametrize("s,hw,c,heads", STREAM_SHAPES)
def test_stream_attention_bf16_matches_plain(dev, s, hw, c, heads):
    _check_stream(dev, "bf16", s, hw, c, heads)


@pytest.mark.parametrize("cache", ["int8", "bf16"])
@pytest.mark.parametrize("s,hw,c,heads", [(2, 4096, 320, 8), (2, 64, 1280, 8), (2, 100, 320, 8)])
def test_stream_attention_sink_only(dev, cache, s, hw, c, heads):
    """All but the 8 sink slots masked to -inf, as at the first streamed
    frames, on the plain 16-byte route, a cluster, and element loads."""
    _check_stream(dev, cache, s, hw, c, heads, visible=8)


def test_stream_attention_shapes_cover_every_route(dev):
    """The shapes above take both staging routes, each with and without a
    cluster."""
    from live2diff_tpu_torch.ops import stream_attention as sa

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    routes = {(staging, cluster > 1) for cache, nbytes in (("int8", 1), ("bf16", 2))
              for staging, cluster in (sa.plan(s, hw, c, h, nbytes, sms)
                                       for s, hw, c, h in STREAM_SHAPES)}
    assert routes == {("tma", False), ("tma", True), ("scalar", False), ("scalar", True)}


@pytest.mark.parametrize("cache", ["int8", "bf16"])
@pytest.mark.parametrize("hw,c", [(4096, 320), (256, 1280), (100, 320)])
def test_stream_attention_repeated_cold_launches_agree(dev, cache, hw, c):
    """100 launches, each on inputs evicted from the L2, bit-equal: copies
    that land out of order must not let a stage be read early, and the
    cluster's sums run in a fixed order."""
    args, plain_args = _stream_args(dev, cache, 2, hw, c, 8, 12, 21)
    kernel = stream_window_attention_int8 if cache == "int8" else stream_window_attention_bf16
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    first = kernel(*args)
    differ = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(100):
        flush.fill_(1)
        differ += (kernel(*args) != first).any()
    assert differ.item() == 0
    assert _rel(first, stream_window_attention_plain(*plain_args)) < ATTN_TOL


# every lanes-a-row instance: 8 lanes (C = 16, 64, 320), 16 (640, and 328,
# which leaves 7 of 48 vector slots idle), 32 (768, 1024, 1280) and a block
# a row (2048, 2560); 8193 rows fill several waves at C = 320 (the
# grid-stride loop with its prefetch)
@pytest.mark.parametrize("rows", [1, 13, 577, 4616, 8193])
@pytest.mark.parametrize("c", [16, 64, 320, 328, 640, 768, 1024, 1280, 2048, 2560])
def test_layer_norm_matches_plain(dev, rows, c):
    """The kernel (8, 16 or 32 lanes a row up to C = 1280, one block a row
    above) against the plain version; ``layer_norm`` launches it at a chosen
    site where the JAX gate does (C % 8 == 0, at least 2^14 elements)."""
    gen = torch.Generator(device=dev).manual_seed(rows * 10 + c)
    x = (_randn(gen, dev, rows, c) * 3.0 + 2.0).to(torch.bfloat16)
    g = (1.0 + 0.1 * _randn(gen, dev, c)).to(torch.bfloat16)
    b = (0.1 * _randn(gen, dev, c)).to(torch.bfloat16)
    ref = layer_norm_plain(x, g, b, 1e-6)
    before = _build.launch_counts["layer_norm"]
    out = layer_norm_rows(x, g, b, 1e-6)
    torch.cuda.synchronize()
    assert _build.launch_counts["layer_norm"] == before + 1
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert _rel(out, ref) < LN_TOL
    gated = x.numel() >= 1 << 14
    assert _rel(layer_norm(x, g, b, 1e-6, site="vit"), ref) < LN_TOL
    assert _build.launch_counts["layer_norm"] == before + 1 + gated
    layer_norm(x, g, b, 1e-6, site="spatial")  # the UNet sites stay plain by default
    assert _build.launch_counts["layer_norm"] == before + 1 + gated


def test_layer_norm_at_the_unet_sites_build_pipeline_chooses(dev):
    """build_pipeline(ln_kernel_sites={"spatial"}) gives the UNet's spatial
    LayerNorms the kernel: at C = 1280, the widest, it launches and agrees."""
    from live2diff_tpu_torch.builder import build_pipeline
    from live2diff_tpu_torch.models.layers import FusedLayerNorm

    cfg = {"num_inference_steps": 50, "t_index_list": [30, 40]}
    tiny = dict(block_out_channels=(32, 64, 64, 64), attention_head_dim=2,
                cross_attention_dim=64, norm_num_groups=8, motion_num_attention_heads=2)
    built = build_pipeline(cfg, 64, 64, dtype=torch.bfloat16, device=dev, use_depth=False,
                           unet_overrides=tiny, ln_kernel_sites={"spatial"})
    kernels = next(m.kernels for m in built.unet.modules()
                   if isinstance(m, FusedLayerNorm) and m.site == "spatial")
    gen = torch.Generator(device=dev).manual_seed(5)
    x = (_randn(gen, dev, 2, 256, 1280) * 3.0 + 2.0).to(torch.bfloat16)
    g = (1.0 + 0.1 * _randn(gen, dev, 1280)).to(torch.bfloat16)
    b = (0.1 * _randn(gen, dev, 1280)).to(torch.bfloat16)
    before = _build.launch_counts["layer_norm"]
    out = layer_norm(x, g, b, 1e-5, site="spatial", kernels=kernels)
    torch.cuda.synchronize()
    assert _build.launch_counts["layer_norm"] == before + 1
    assert _rel(out, layer_norm_plain(x, g, b, 1e-5)) < LN_TOL
    layer_norm(x, g, b, 1e-5, site="temporal", kernels=kernels)  # not chosen
    assert _build.launch_counts["layer_norm"] == before + 1


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 8, 2, 112, device=dev, dtype=torch.bfloat16)  # D = 112: no tile width
    with pytest.raises(ValueError):
        flash_attention(q, q, q, 0.1)
    with pytest.raises(TypeError):
        flash_attention(q.float(), q.float(), q.float(), 0.1)
    x = torch.zeros(1, 8, 8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # Cout must be 64
        conv3x3(x, torch.zeros(32, 64, 3, 3, device=dev, dtype=torch.bfloat16))
    # a bias has no kernel: the dense path, no flash launch, the CPU's result
    before = _build.launch_counts["flash_attention"]
    qb = torch.randn(1, 8, 2, 64, device=dev).to(torch.bfloat16)
    bias = torch.triu(torch.full((8, 8), float("-inf"), device=dev), 1)[None, None]
    out = dot_product_attention(qb, qb, qb, bias=bias)
    assert _build.launch_counts["flash_attention"] == before
    ref = dot_product_attention(qb.cpu(), qb.cpu(), qb.cpu(), bias=bias.cpu())
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-2, atol=1e-2)
    with pytest.raises(ValueError):  # C % 8 != 0
        layer_norm_rows(torch.zeros(4, 20, device=dev, dtype=torch.bfloat16),
                        torch.ones(20, device=dev, dtype=torch.bfloat16),
                        torch.zeros(20, device=dev, dtype=torch.bfloat16))
    # C = 2048: one block a row, no longer refused
    x = torch.randn(4, 2048, device=dev).to(torch.bfloat16)
    g, b = (torch.ones(2048, device=dev, dtype=torch.bfloat16),
            torch.zeros(2048, device=dev, dtype=torch.bfloat16))
    assert _rel(layer_norm_rows(x, g, b), layer_norm_plain(x, g, b)) < LN_TOL
    with pytest.raises(ValueError):  # C > 10240
        layer_norm_rows(torch.zeros(4, 10248, device=dev, dtype=torch.bfloat16),
                        torch.ones(10248, device=dev, dtype=torch.bfloat16),
                        torch.zeros(10248, device=dev, dtype=torch.bfloat16))
    s, hw, c = 2, 8, 16
    with pytest.raises(TypeError, match="int8 or bf16"):  # an fp32 cache has no kernel
        stream_window_attention(
            torch.zeros(s, hw, c, device=dev, dtype=torch.bfloat16),
            torch.zeros(s, 2, 16, c, hw, device=dev, dtype=torch.float32),
            torch.zeros(s, c, device=dev), torch.zeros(s, 16, c, device=dev),
            torch.zeros(s, 16, c, device=dev), torch.zeros(s, 16, device=dev), 2,
        )


def _bhsd(gen, dev, b, s, h, d):
    """A [B, H, S, D] view of a [B, S, H, D] tensor, as the model hands it."""
    return _randn(gen, dev, b, s, h, d).to(torch.bfloat16).transpose(1, 2)


@pytest.mark.parametrize("b,h,s,d,block_q,block_k", [
    (1, 2, 100, 40, 512, 1024),   # one key block shorter than a tile pair
    (2, 3, 130, 80, 512, 1024),   # ragged query and key tiles
    (1, 2, 384, 64, 128, 128),    # three key blocks
    (2, 2, 1024, 40, 512, 256),   # four key blocks at a production width
    (1, 1, 200, 8, 512, 1024),
])
def test_flash_smajor_matches_plain(dev, b, h, s, d, block_q, block_k):
    gen = torch.Generator(device=dev).manual_seed(s * 100 + d)
    q, k, v = (_bhsd(gen, dev, b, s, h, d) for _ in range(3))
    before = _build.launch_counts["flash_attention_smajor"]
    out = flash_self_attention(q, k, v, d ** -0.5, block_q, block_k)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention_smajor"] == before + 1
    assert out.shape == q.shape and out.stride() == q.stride()
    # p against the same block max on both sides: fp32 order and exp only
    ref = flash_self_attention_plain(q, k, v, d ** -0.5, block_q, block_k)
    assert _rel(out, ref) < ATTN_TOL
    assert _rms(out, ref) < VARIANT_RMS_TOL


@pytest.mark.parametrize("b,h,s,d,block_q,block_k", [
    (1, 2, 200, 40, 512, 1024),   # one group each way, ragged tiles
    (2, 2, 384, 80, 128, 256),    # 3 q groups, 3 k groups (pick_block: 128)
    (1, 2, 1024, 64, 512, 1024),  # 2 q groups, one k group
    (2, 1, 640, 40, 128, 640),    # 5 q groups, 640-row k group (10 tiles)
    (1, 2, 4096, 80, 512, 4096),  # D = 80 at S = 4096: one 4096-row key group
    (1, 1, 4096, 40, 512, 4096),  # the main width, B * H = 1
    (1, 2, 100, 8, 512, 1024),    # S < 128, the narrowest D
    (1, 1, 300, 160, 512, 1024),  # D = 160: 64-key tiles, 2 code chunks
    (1, 2, 256, 128, 128, 128),   # D = 128, 2 key groups
])
def test_flash_int8_matches_plain(dev, b, h, s, d, block_q, block_k):
    gen = torch.Generator(device=dev).manual_seed(s * 100 + d + 7)
    q, v = _bhsd(gen, dev, b, s, h, d), _bhsd(gen, dev, b, s, h, d)
    k = (_randn(gen, dev, b, s, h, d) + 0.7).to(torch.bfloat16).transpose(1, 2)
    before = _build.launch_counts["flash_attention_int8"]
    out = flash_self_attention_int8(q, k, v, d ** -0.5, block_q, block_k)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention_int8"] == before + 1
    assert out.shape == q.shape
    # the same int8 codes and exact integer Q.K on both sides, p against the
    # key group's max on both: fp32 order and exp only
    ref = flash_self_attention_int8_plain(q, k, v, d ** -0.5, block_q, block_k)
    assert _rel(out, ref) < INT8_TOL
    assert _rms(out, ref) < VARIANT_RMS_TOL
    # the RMS tolerance tells the int8 function from the unquantised one
    unq = flash_self_attention_plain(q, k, v, d ** -0.5, block_q, block_k)
    assert _rms(unq, ref) > 5 * VARIANT_RMS_TOL


# the pre-pass at the four 512x512 shapes of the int8 phase (blocks 512 and
# min(S, 4096)), at S < 128 (one group of 100 rows, no cluster), and at a
# 1000-row key group split over a cluster of 4 CTAs of 250 rows
@pytest.mark.parametrize("b,h,s,d,block_q,block_k", [
    (2, 8, 4096, 40, 512, 4096), (2, 8, 1024, 80, 512, 1024),
    (8, 8, 4096, 40, 512, 4096), (8, 8, 1024, 80, 512, 1024),
    (1, 2, 100, 40, 512, 1024), (2, 3, 1000, 80, 1024, 1024),
])
def test_flash_int8_prepass_matches_quantize_groups(dev, b, h, s, d, block_q, block_k):
    gen = torch.Generator(device=dev).manual_seed(s + d)
    q = _bhsd(gen, dev, b, s, h, d)
    # per-channel spread, as activations have: groups with other maxima
    k = (_randn(gen, dev, b, s, h, d) * torch.rand(1, 1, h, d, generator=gen, device=dev) * 4
         ).to(torch.bfloat16).transpose(1, 2)
    before = dict(_build.launch_counts)
    q8, sq, k8, sk = quantize_groups_cuda(q, k, block_q, block_k)
    torch.cuda.synchronize()
    assert _build.launch_counts == before  # a check entry: no launch is counted
    for codes, scales, x, block in ((q8, sq, q, block_q), (k8, sk, k, block_k)):
        ref_codes, ref_scales = quantize_groups(x, pick_block(s, block))
        assert codes.dtype == torch.int8 and codes.shape == x.shape
        assert torch.equal(scales, ref_scales)
        assert torch.equal(codes.float(), ref_codes)


@pytest.mark.parametrize("b,h,s,d,block_k", [
    (2, 8, 4096, 40, 4096), (2, 8, 1024, 80, 1024), (1, 2, 640, 40, 128),
])
def test_flash_int8_repeated_cold_launches_agree(dev, b, h, s, d, block_k):
    """100 launches, each on inputs evicted from the L2, bit-equal: the
    pre-pass's cluster meeting and the core's ring may not depend on timing."""
    gen = torch.Generator(device=dev).manual_seed(31 + s)
    q, k, v = (_bhsd(gen, dev, b, s, h, d) for _ in range(3))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    first = flash_self_attention_int8(q, k, v, d ** -0.5, 512, block_k)
    differ = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(100):
        flush.fill_(1)
        differ += (flash_self_attention_int8(q, k, v, d ** -0.5, 512, block_k) != first).any()
    assert differ.item() == 0
    ref = flash_self_attention_int8_plain(q, k, v, d ** -0.5, 512, block_k)
    assert _rel(first, ref) < INT8_TOL


@pytest.mark.parametrize("rows,c", [(577, 768), (8192, 320), (32768, 320), (1000, 2560)])
def test_layer_norm_repeated_cold_launches_agree(dev, rows, c):
    """200 launches, each on inputs evicted from the L2, bit-equal: sums in a
    fixed order whatever the grid and the loop's prefetch."""
    gen = torch.Generator(device=dev).manual_seed(rows + c)
    x = (_randn(gen, dev, rows, c) * 3.0 + 2.0).to(torch.bfloat16)
    g = (1.0 + 0.1 * _randn(gen, dev, c)).to(torch.bfloat16)
    b = (0.1 * _randn(gen, dev, c)).to(torch.bfloat16)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    first = layer_norm_rows(x, g, b, 1e-6)
    differ = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(200):
        flush.fill_(1)
        differ += (layer_norm_rows(x, g, b, 1e-6) != first).any()
    assert differ.item() == 0
    assert _rel(first, layer_norm_plain(x, g, b, 1e-6)) < LN_TOL


# ragged row counts across tile edges (4097, 333, 1000 rows), B = 3 and 16,
# C = 4096 with 512 groups and with 32, C / G < 8 (a 16-byte vector spans
# groups), T * C at exactly 3 * 2^20, the widest row (GN_MAX_CHANNELS, with
# one channel a group), and prepare's [8, 4096, 640], whose tiles do not all
# fit (the streamed route)
@pytest.mark.parametrize("b,t,c,groups", [
    (2, 1000, 64, 32), (1, 37, 320, 32), (3, 4097, 320, 32), (2, 64, 1280, 32),
    (1, 129, 2560, 32), (2, 50, 24, 4),
    (1, 64, 4096, 512), (1, 512, 4096, 32), (2, 50, 64, 16), (16, 64, 320, 32),
    (2, 4096, 768, 32), (8, 4096, 640, 32), (3, 333, 1280, 32), (1, 4097, 640, 32),
    (1, 40, 16384, 16384), (1, 300, 16384, 32),
])
@pytest.mark.parametrize("act,eps", [("none", 1e-5), ("silu", 1e-6), ("relu", 1e-5)])
def test_group_norm_matches_plain(dev, b, t, c, groups, act, eps):
    gen = torch.Generator(device=dev).manual_seed(t * 10 + c)
    x = (_randn(gen, dev, b, t, c) * 3.0 + 2.0).to(torch.bfloat16)
    g = (1.0 + 0.1 * _randn(gen, dev, c)).to(torch.bfloat16)
    bt = (0.1 * _randn(gen, dev, c)).to(torch.bfloat16)
    before, routes = _build.launch_counts["group_norm"], dict(gn_route_counts)
    out = group_norm(x, g, bt, groups, eps, act)
    torch.cuda.synchronize()
    assert _build.launch_counts["group_norm"] == before + 1
    plan = group_norm_plan(b, t, c, groups, *gn_device_limits(0))
    assert gn_route_counts[plan.route] == routes[plan.route] + 1
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert _rel(out, group_norm_plain(x, g, bt, groups, eps, act)) < GN_TOL


def test_group_norm_takes_every_shape_the_jax_gate_sends_it(dev):
    """group_norm_act at C = 4096 with 512 groups (the JAX gate takes it,
    the kernel before this design refused it) launches the kernel; past the
    kernel's widest row it runs the plain version."""
    gen = torch.Generator(device=dev).manual_seed(4096)
    kernels = KernelChoices(gn_kernel_sites="all")
    for c, groups, launched in ((4096, 512, 1), (16392, 8, 0)):
        x = (_randn(gen, dev, 1, 64, c) * 3.0 + 2.0).to(torch.bfloat16)
        g = (1.0 + 0.1 * _randn(gen, dev, c)).to(torch.bfloat16)
        bt = (0.1 * _randn(gen, dev, c)).to(torch.bfloat16)
        before = _build.launch_counts["group_norm"]
        out = group_norm_act(x, g, bt, groups, 1e-5, "silu", site="resnet", kernels=kernels)
        torch.cuda.synchronize()
        assert _build.launch_counts["group_norm"] == before + launched
        assert _rel(out, group_norm_plain(x, g, bt, groups, 1e-5, "silu")) < GN_TOL


@pytest.mark.parametrize("b,t,c,groups", [
    (2, 4096, 320, 32), (1, 576, 256, 32), (1, 64, 4096, 512), (8, 4096, 640, 32),
])
def test_group_norm_repeated_cold_launches_agree(dev, b, t, c, groups):
    """200 launches, each on inputs evicted from the L2, bit-equal: the CTAs
    of a sample merge its tile partials in a fixed order whatever order
    they arrive in."""
    gen = torch.Generator(device=dev).manual_seed(b + t + c)
    x = (_randn(gen, dev, b, t, c) * 3.0 + 2.0).to(torch.bfloat16)
    g = (1.0 + 0.1 * _randn(gen, dev, c)).to(torch.bfloat16)
    bt = (0.1 * _randn(gen, dev, c)).to(torch.bfloat16)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    first = group_norm(x, g, bt, groups, 1e-5, "silu")
    differ = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(200):
        flush.fill_(1)
        differ += (group_norm(x, g, bt, groups, 1e-5, "silu") != first).any()
    assert differ.item() == 0
    assert _rel(first, group_norm_plain(x, g, bt, groups, 1e-5, "silu")) < GN_TOL


@pytest.mark.parametrize("b,t,c", [(2, 4096, 320), (1, 576, 256), (8, 4096, 640)])
def test_group_norm_is_one_device_kernel_a_call(dev, b, t, c):
    """A torch.profiler trace of 10 calls holds 10 device kernels, all the
    GroupNorm kernel: no memset, no second or third launch."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(c)
    x = _randn(gen, dev, b, t, c).to(torch.bfloat16)
    g = torch.ones(c, device=dev, dtype=torch.bfloat16)
    group_norm(x, g, g, 32, 1e-5, "relu")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            group_norm(x, g, g, 32, 1e-5, "relu")
        torch.cuda.synchronize()
    kernels = Counter()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] += e.count
    assert sum(kernels.values()) == 10, kernels
    assert all("group_norm_kernel" in k for k in kernels), kernels


@pytest.mark.parametrize("b,t,c,groups", [(2, 1024, 640, 32), (8, 4096, 640, 32)])
def test_group_norm_replays_in_a_cuda_graph(dev, b, t, c, groups):
    """One call captured in a CUDA graph and replayed 3 times equals the
    eager call bit for bit: the grid's meeting needs nothing from the host."""
    gen = torch.Generator(device=dev).manual_seed(t + c)
    x = (_randn(gen, dev, b, t, c) * 3.0 + 2.0).to(torch.bfloat16)
    g = (1.0 + 0.1 * _randn(gen, dev, c)).to(torch.bfloat16)
    bt = (0.1 * _randn(gen, dev, c)).to(torch.bfloat16)
    eager = group_norm(x, g, bt, groups, 1e-5, "silu")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        group_norm(x, g, bt, groups, 1e-5, "silu")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = group_norm(x, g, bt, groups, 1e-5, "silu")
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_new_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 2, 256, 112, device=dev, dtype=torch.bfloat16)  # D = 112
    with pytest.raises(ValueError):
        flash_self_attention(q, q, q, 0.1)
    with pytest.raises(ValueError):
        flash_self_attention_int8(q, q, q, 0.1)
    q = torch.zeros(1, 2, 1000, 40, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # 1000 > 512 has no 128-multiple block dividing it
        flash_self_attention_int8(q, q, q, 0.1)
    q = torch.zeros(1, 2, 256, 40, device=dev, dtype=torch.float32)
    with pytest.raises(TypeError):
        flash_self_attention(q, q, q, 0.1)
    g = torch.ones(36, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # C % 8 != 0
        group_norm(torch.zeros(1, 4, 36, device=dev, dtype=torch.bfloat16), g, g, 4)
    g = torch.ones(64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # C % groups != 0
        group_norm(torch.zeros(1, 4, 64, device=dev, dtype=torch.bfloat16), g, g, 24)
    g = torch.ones(16392, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # C > GN_MAX_CHANNELS: group_norm_act's gate sends it plain
        group_norm(torch.zeros(1, 4, 16392, device=dev, dtype=torch.bfloat16), g, g, 8)
