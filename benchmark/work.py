"""Work counts from a configuration's shapes: FLOPs and bytes of one call.

A call of the entry is one frame for each of the traffic's S sessions: the
stream-batch UNet over S * n step rows (n = len(t_index_list)) at one
frame each, the DPT-hybrid on S images at 384x384, the TAESD encoder on
2S images (frames and depth images) and its decoder on S latents.

Model FLOPs count the products of matrices and convolutions only, two a
multiply-add: ``2 * Cout * Cin * k * k * Ho * Wo`` a conv, ``2 * rows * in
* out`` a linear, ``4 * Sq * Sk * C`` an attention (its two products over
all heads). Norms, activations, resizes and the LCM arithmetic are not
counted. The motion modules' positional-encoding projections (the window's
16 rows through the q, k and v maps) are counted, as the model runs them
each call. The temporal attention of a stream step reads the whole
16-slot window.

The attention work counts are of the calls themselves, at the cell's
shapes, whatever kernels serve them: FLOPs as above, bytes as each input
read once and each output written once.

A configuration that names its own reference module (``"reference"``, see
``reference/stream.py``) brings its own counts there: the codec's FLOPs as
``codec_flops(cfg, height, width, encodes, decodes)`` in place of TAESD's,
and the attention calls of its own models as
``flash_attention_calls(cfg, traffic)`` and
``stream_attention_calls(cfg, traffic)``, added to the UNet's and the
DPT's. A module that defines none of them is counted as ``models.py``.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict, Iterator, List, Optional, Tuple

BF16 = 2
FP32 = 4
CACHE_BYTES = {"bf16": 2, "bfloat16": 2, "int8": 1, "fp32": 4, "float32": 4}


def conv(cin: int, cout: int, k: int, ho: int, wo: int, n: int = 1) -> float:
    return 2.0 * n * cout * cin * k * k * ho * wo


def lin(rows: int, cin: int, cout: int) -> float:
    return 2.0 * rows * cin * cout


def attn(n: int, sq: int, sk: int, c: int) -> float:
    return 4.0 * n * sq * sk * c


def level_dims(h: int, w: int, levels: int) -> List[Tuple[int, int]]:
    dims = [(h, w)]
    for _ in range(levels - 1):
        dims.append((-(-dims[-1][0] // 2), -(-dims[-1][1] // 2)))
    return dims


def unet_layout(u: Dict) -> Iterator[Tuple[str, int, int, int]]:
    """The UNet's blocks in call order: (kind, level, cin, cout) with kind
    ``resnet``, ``spatial``, ``motion``, ``down`` or ``up`` (cin = cout
    but for resnets)."""
    ch = u["block_out_channels"]
    n = len(ch)
    mres = u["motion_module_resolutions"]
    skips, cur = [ch[0]], ch[0]
    for i, kind in enumerate(u["down_block_types"]):
        for _ in range(u["layers_per_block"]):
            yield "resnet", i, cur, ch[i]
            cur = ch[i]
            if kind == "CrossAttnDownBlock3D":
                yield "spatial", i, cur, cur
            if 2 ** i in mres:
                yield "motion", i, cur, cur
            skips.append(cur)
        if i < n - 1:
            yield "down", i, cur, cur
            skips.append(cur)
    yield "resnet", n - 1, cur, ch[-1]
    yield "spatial", n - 1, ch[-1], ch[-1]
    yield "resnet", n - 1, ch[-1], ch[-1]
    cur = ch[-1]
    rev = list(reversed(ch))
    for i, kind in enumerate(u["up_block_types"]):
        level = n - 1 - i
        for _ in range(u["layers_per_block"] + 1):
            yield "resnet", level, cur + skips.pop(), rev[i]
            cur = rev[i]
            if kind == "CrossAttnUpBlock3D":
                yield "spatial", level, cur, cur
            if 2 ** level in mres:
                yield "motion", level, cur, cur
        if i < n - 1:
            yield "up", level - 1, cur, cur


def unet_flops(u: Dict, lh: int, lw: int, rows: int, text_len: int = 77) -> float:
    """One stream-mode UNet call over ``rows`` step rows, one frame each."""
    ch = u["block_out_channels"]
    temb = 4 * ch[0]
    dims = level_dims(lh, lw, len(ch))
    hw0 = lh * lw
    ctx = u["cross_attention_dim"]
    window = u["window_size"]
    n_attn = len(u["motion_attention_block_types"]) * u["motion_num_transformer_block"]
    f = lin(rows, ch[0], temb) + lin(rows, temb, temb)
    f += conv(u["in_channels"], ch[0], 3, lh, lw, rows)
    if u["cond_mapping"]:
        widths = u["mapping_channels"]
        f += conv(u["in_channels"], widths[0], 3, lh, lw, rows)
        for a, b in zip(widths[:-1], widths[1:]):
            f += conv(a, a, 3, lh, lw, rows) + conv(a, b, 3, lh, lw, rows)
        f += conv(widths[-1], ch[0], 3, lh, lw, rows)
    for kind, level, cin, c in unet_layout(u):
        h, w = dims[level]
        hw = h * w
        if kind == "resnet":
            f += conv(cin, c, 3, h, w, rows) + conv(c, c, 3, h, w, rows) + lin(rows, temb, c)
            if cin != c:
                f += conv(cin, c, 1, h, w, rows)
        elif kind == "spatial":
            t = rows * hw
            f += 2 * lin(t, c, c)  # proj_in, proj_out
            f += 4 * lin(t, c, c) + attn(rows, hw, hw, c)  # self-attention
            f += 2 * lin(t, c, c) + 2 * lin(rows * text_len, ctx, c)  # cross: q, out; k, v
            f += attn(rows, hw, text_len, c)
            f += lin(t, c, 8 * c) + lin(t, 4 * c, c)  # GEGLU feed-forward
        elif kind == "motion":
            t = rows * hw
            f += 2 * lin(t, c, c)  # proj_in, proj_out
            for _ in range(n_attn):
                f += 4 * lin(t, c, c) + 3 * lin(window, c, c) + attn(rows, hw, window, c)
            f += lin(t, c, 8 * c) + lin(t, 4 * c, c)
        elif kind == "down":
            ho, wo = dims[level + 1]
            f += conv(c, c, 3, ho, wo, rows)
        elif kind == "up":
            f += conv(c, c, 3, h, w, rows)
    f += conv(ch[0], u["out_channels"], 3, lh, lw, rows)
    del hw0
    return f


def dpt_flops(d: Dict, images: int) -> float:
    """The DPT-hybrid on ``images`` images at its input size."""
    s = d["image_size"]
    g, dim, feats = d["patch_grid"], d["vit_hidden"], d["features"]
    r = d["reassemble_channels"]
    f = conv(3, 64, 7, s // 2, s // 2)
    size, cin = s // 4, 64  # after the stem's max pool
    taps = []
    for stage, (cout, blocks) in enumerate(zip(d["stage_channels"], d["resnet_layers"])):
        for i in range(blocks):
            stride = 2 if stage and i == 0 else 1
            mid = cout // 4
            out = size // stride
            f += conv(cin, mid, 1, size, size) + conv(mid, mid, 3, out, out)
            f += conv(mid, cout, 1, out, out)
            if cin != cout or stride != 1:
                f += conv(cin, cout, 1, out, out)
            size, cin = out, cout
        taps.append((size, cout))
    f += conv(cin, dim, 1, g, g)
    tokens = g * g + 1
    f += d["vit_layers"] * (lin(tokens, dim, 3 * dim) + attn(1, tokens, tokens, dim)
                            + lin(tokens, dim, dim) + lin(tokens, dim, d["vit_mlp"])
                            + lin(tokens, d["vit_mlp"], dim))
    f += 2 * lin(g * g, 2 * dim, dim) + 2 * conv(dim, r, 1, g, g) + conv(r, r, 3, g // 2, g // 2)
    (s1, c1), (s2, c2) = taps[0], taps[1]
    f += conv(c1, feats, 3, s1, s1) + conv(c2, feats, 3, s2, s2)
    f += conv(r, feats, 3, g, g) + conv(r, feats, 3, g // 2, g // 2)
    for size, skip in ((g // 2, False), (g, True), (s2, True), (s1, True)):
        units = 2 if skip else 1
        f += units * 2 * conv(feats, feats, 3, size, size) + conv(feats, feats, 1, 2 * size,
                                                                   2 * size)
    out = 2 * s1
    f += conv(feats, feats // 2, 3, out, out) + conv(feats // 2, 32, 3, 2 * out, 2 * out)
    f += conv(32, 1, 1, 2 * out, 2 * out)
    return images * f


def taesd_flops(t: Dict, height: int, width: int, encodes: int, decodes: int) -> float:
    """TAESD's encoder on ``encodes`` images and decoder on ``decodes``
    latents of a ``height`` x ``width`` frame."""
    hid, lat = t["hidden"], t["latent_channels"]

    def block(h, w):
        return 3 * conv(hid, hid, 3, h, w)

    enc = conv(3, hid, 3, height, width)
    h, w = height, width
    for stage, n in enumerate(t["encoder_blocks"]):
        if stage:
            h, w = -(-h // 2), -(-w // 2)
            enc += conv(hid, hid, 3, h, w)
        enc += n * block(h, w)
    enc += conv(hid, lat, 3, h, w)
    lh, lw = height // 8, width // 8
    dec = conv(lat, hid, 3, lh, lw)
    h, w = lh, lw
    for _ in range(3):
        dec += 3 * block(h, w)
        h, w = 2 * h, 2 * w
        dec += conv(hid, hid, 3, h, w)
    dec += block(h, w) + conv(hid, 3, 3, h, w)
    return encodes * enc + decodes * dec


def own_module(cfg: Dict) -> Optional[ModuleType]:
    """The configuration's own reference module, where it names one."""
    if "reference" not in cfg:
        return None
    from reference.stream import reference_module

    return reference_module(cfg)


def own_calls(cfg: Dict, traffic: Dict, name: str) -> List[Tuple[float, float]]:
    """The calls that the configuration's own module reports by ``name``."""
    count = getattr(own_module(cfg), name, None)
    return list(count(cfg, traffic)) if count is not None else []


def model_flops(cfg: Dict, traffic: Dict) -> float:
    """Model FLOPs of one call of the entry (S frames)."""
    s = traffic["sessions"]
    h, w = traffic["height"], traffic["width"]
    rows = s * len(cfg["t_index_list"])
    f = unet_flops(cfg["unet"], h // 8, w // 8, rows, cfg["prompt_shape"][1])
    encodes = (2 if cfg["use_depth"] else 1) * s
    codec = getattr(own_module(cfg), "codec_flops", None)
    f += (codec(cfg, h, w, encodes, s) if codec is not None
          else taesd_flops(cfg["taesd"], h, w, encodes, s))
    if cfg["use_depth"]:
        f += dpt_flops(cfg["dpt"], s)
    return f


# ---------------------------------------------------------------------------
# attention calls, for the kernels' rooflines
# ---------------------------------------------------------------------------


def stream_attention_calls(cfg: Dict, traffic: Dict) -> List[Tuple[float, float]]:
    """(FLOPs, bytes) of each temporal KV-cache attention of one call: the
    new frame's queries of every step row against the row's 16-slot
    window. Bytes: the queries and the output in bf16, K and V of the
    window at the cache dtype, with one fp32 scale a (slot, channel) for an
    int8 cache. Then the calls of the configuration's own module."""
    u = cfg["unet"]
    rows = traffic["sessions"] * len(cfg["t_index_list"])
    dims = level_dims(traffic["height"] // 8, traffic["width"] // 8,
                      len(u["block_out_channels"]))
    window = u["window_size"]
    elem = CACHE_BYTES[cfg["kv_cache_dtype"]]
    n_attn = len(u["motion_attention_block_types"]) * u["motion_num_transformer_block"]
    out = []
    for kind, level, _, c in unet_layout(u):
        if kind != "motion":
            continue
        hw = dims[level][0] * dims[level][1]
        flops = attn(rows, hw, window, c)
        nbytes = 2 * rows * hw * c * BF16 + 2 * rows * window * c * hw * elem
        if cfg["kv_cache_dtype"] == "int8":
            nbytes += 2 * rows * window * c * FP32
        out += [(flops, nbytes)] * n_attn
    return out + own_calls(cfg, traffic, "stream_attention_calls")


def flash_attention_calls(cfg: Dict, traffic: Dict) -> List[Tuple[float, float]]:
    """(FLOPs, bytes) of each softmax attention over a whole sequence in one
    call: the UNet's spatial self- and cross-attentions over the step
    rows, and the DPT's ViT self-attentions, one image a session. Bytes: q,
    k, v and the output in bf16. Then the calls of the configuration's own
    module."""
    u = cfg["unet"]
    s = traffic["sessions"]
    rows = s * len(cfg["t_index_list"])
    dims = level_dims(traffic["height"] // 8, traffic["width"] // 8,
                      len(u["block_out_channels"]))
    text = cfg["prompt_shape"][1]
    out = []
    for kind, level, _, c in unet_layout(u):
        if kind != "spatial":
            continue
        hw = dims[level][0] * dims[level][1]
        out.append((attn(rows, hw, hw, c), 4 * rows * hw * c * BF16))
        out.append((attn(rows, hw, text, c), 2 * rows * (hw + text) * c * BF16))
    if cfg["use_depth"]:
        d = cfg["dpt"]
        tokens = d["patch_grid"] ** 2 + 1
        dim = d["vit_hidden"]
        out += [(attn(s, tokens, tokens, dim), 4 * s * tokens * dim * BF16)] * d["vit_layers"]
    return out + own_calls(cfg, traffic, "flash_attention_calls")


def least_seconds(calls: List[Tuple[float, float]], flops_peak: float,
                  bytes_peak: float) -> float:
    """The least time the calls could take one after another on a device
    of these peaks: each call's larger of FLOPs over the FLOP peak and bytes
    over the bandwidth."""
    return sum(max(f / flops_peak, b / bytes_peak) for f, b in calls)
