"""The ``sd15-live2diff-demo-kl`` configuration against its plain reference
(``benchmark/reference/kl.py``), on the CPU.

* The port's ``AutoencoderKL`` (``encode``'s mean times the scaling, as the
  stream takes it, and ``decode`` of latents over the scaling) against the
  reference's ``encode`` and ``decode`` on the same seeded weights, at a
  narrow width, both in fp32.
* The reference's parameters equal the program's by name and shape: the
  codec at the published widths (on the meta device), and a whole CPU-built
  program of a narrowed KL configuration (``harness.program_parameters``).
* ``codec_flops`` and ``codec_attention_calls`` against a FLOP counter over
  the reference's modules.
* A tiny cell of the narrowed configuration rehearsed through the harness
  reads ``correct``; a reference whose decode flips the sign reads
  ``correct: false``.
* The module loads neither JAX nor the program, in a process of its own.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import live2diff_tpu_torch.builder as port_builder
from live2diff_tpu_torch.models.vae import AutoencoderKL, VAEConfig

REPO = Path(__file__).resolve().parents[1]
BENCH = REPO / "benchmark"
sys.path.insert(0, str(BENCH / "tests"))
sys.path.insert(0, str(BENCH))

import bench_tiny_cell  # noqa: E402
import harness  # noqa: E402
import weights  # noqa: E402
from reference import stream as ref_stream  # noqa: E402

CELL = "demo-kl-512-1stream"
KL = json.loads((BENCH / "configs/sd15-live2diff-demo-kl.json").read_text())
NARROW_VAE = dict(block_out_channels=[16, 32, 32, 32], norm_num_groups=8)
# fp32 on both sides, the same convolutions, norms and products in another
# order of summation: relative RMS errors of 1.3e-6 (encode) and 8.5e-7
# (decode) at this width, so 1e-5 leaves a factor of 7 and catches a
# dropped attention, shortcut or quant conv, or the pad on the wrong side
# (0.09 and more)
TOL = 1e-5
# a window that holds more than lag + 1 calls even on a loaded host
WINDOW_S = 5.0


def narrow_config() -> dict:
    """The KL configuration at the tiny cell's UNet, without depth, with a
    narrow codec (the published block structure, narrower widths)."""
    cfg = bench_tiny_cell.tiny_config()
    cfg.update(use_tiny_vae=False, reference="kl.py", vae=dict(KL["vae"], **NARROW_VAE))
    cfg.pop("taesd")
    cfg["reduced"] = sorted(cfg["reduced"] + ["vae"])
    return cfg


def narrow_vae_config() -> VAEConfig:
    v = NARROW_VAE
    return VAEConfig(block_out_channels=tuple(v["block_out_channels"]),
                     norm_num_groups=v["norm_num_groups"])


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


def reference_module(cfg: dict):
    return ref_stream.reference_module(dict(cfg, reference=str(BENCH / "reference/kl.py")))


@pytest.fixture(scope="module")
def codecs():
    """(the reference's codec, the port's) at the narrow width, fp32, on
    the same weights drawn by the benchmark's rule from one seed."""
    cfg = narrow_config()
    ref = reference_module(cfg).AutoencoderKL(cfg["vae"]).eval().requires_grad_(False)
    port = AutoencoderKL(narrow_vae_config()).eval().requires_grad_(False)
    shapes = [("vae", n, tuple(p.shape)) for n, p in ref.named_parameters()]
    into = {"vae": dict(ref.named_parameters())}
    weights.fill(shapes, 11, torch.float32, "cpu", into)
    into = {"vae": dict(port.named_parameters())}
    weights.fill(shapes, 11, torch.float32, "cpu", into)
    return ref, port


def test_port_encode_matches_the_reference(codecs):
    ref, port = codecs
    x = torch.rand(2, 32, 48, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
    with torch.no_grad():
        want = ref.encode(x)
        got = port.encode(x) * port.config.scaling_factor
    assert got.shape == want.shape == (2, 4, 6, 4)
    assert rel_rms(got, want) < TOL


def test_port_decode_matches_the_reference(codecs):
    ref, port = codecs
    z = torch.randn(1, 4, 6, 4, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = ref.decode(z)
        got = port.decode(z / port.config.scaling_factor)
    assert got.shape == want.shape == (1, 32, 48, 3)
    assert rel_rms(got, want) < TOL


def test_published_codec_parameters_equal_the_programs():
    """At the configuration's own widths, on the meta device: the
    reference's codec holds the program's ``AutoencoderKL()`` parameters by
    name and shape (83.7 M of them)."""
    with torch.device("meta"):
        ref = reference_module(KL).AutoencoderKL(KL["vae"])
        port = AutoencoderKL(VAEConfig())
    want = {n: tuple(p.shape) for n, p in ref.named_parameters()}
    assert want == {n: tuple(p.shape) for n, p in port.named_parameters()}
    assert sum(p.numel() for p in port.parameters()) == 83_653_863


def test_reference_shapes_equal_a_cpu_built_programs(tmp_path, monkeypatch):
    """``reference.stream.shapes`` of the narrowed KL configuration against
    ``harness.program_parameters`` of the program the harness builds from
    it on the CPU (the program's codec narrowed to the same widths)."""
    from live2diff_tpu_torch.wrapper import StreamV2VWrapper

    monkeypatch.setattr(port_builder, "VAEConfig", narrow_vae_config)
    root = bench_tiny_cell.make_root(tmp_path, narrow_config())
    cell, _ = harness.find_cell(root, "tiny-64")
    wrapper = StreamV2VWrapper(**harness.wrapper_kwargs(cell, 3, "cpu", root))
    have = [(m, n, tuple(p.shape)) for m, ps in harness.program_parameters(wrapper.built).items()
            for n, p in ps.items()]
    want = ref_stream.shapes(cell.cfg)
    assert sorted(have) == sorted(want)
    assert {m for m, _, _ in want} == {"unet", "vae"}


def counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("hw", [(32, 48), (64, 64)])
def test_codec_flops_match_a_counter(codecs, hw):
    ref, _ = codecs
    h, w = hw
    module = reference_module(narrow_config())
    enc = counted(lambda: ref.encode(torch.rand(2, h, w, 3)))
    dec = counted(lambda: ref.decode(torch.rand(1, h // 8, w // 8, 4)))
    assert module.codec_flops(narrow_config(), h, w, 2, 1) == enc + dec


@pytest.mark.parametrize("use_depth,sessions", [(True, 1), (False, 2)])
def test_codec_attention_calls_match_a_counter(codecs, use_depth, sessions):
    """One call a codec attention: the encode's over the frames (and the
    depth images), the decode's over one latent a session; FLOPs as a
    counter gives them over the reference's attention module, bytes the
    input, the output and the four weights in bf16."""
    ref, _ = codecs
    cfg = dict(narrow_config(), use_depth=use_depth)
    traffic = {"sessions": sessions, "height": 64, "width": 96}
    calls = reference_module(cfg).codec_attention_calls(cfg, traffic)
    c = NARROW_VAE["block_out_channels"][-1]
    encodes = (2 if use_depth else 1) * sessions
    want = []
    for n, attn in ((encodes, ref.encoder.mid_block.attentions[0]),
                    (sessions, ref.decoder.mid_block.attentions[0])):
        flops = counted(lambda: attn(torch.rand(n, 8, 12, c)))
        want.append((flops, 2.0 * (2 * n * 96 * c + 4 * c * c)))
    assert calls == want


def test_published_work_counts():
    """At 512x512 with depth: about 1.1 TFLOP an encode, 2.5 a decode, and
    the codec's attentions (86 and 43 GFLOP) counted apart from the flash
    kernels' calls."""
    module = reference_module(KL)
    enc = module.codec_flops(KL, 512, 512, 1, 0)
    dec = module.codec_flops(KL, 512, 512, 0, 1)
    assert 1.0e12 < enc < 1.2e12 and 2.4e12 < dec < 2.6e12
    traffic = {"sessions": 1, "height": 512, "width": 512}
    (enc_attn, _), (dec_attn, _) = module.codec_attention_calls(KL, traffic)
    assert enc_attn == 2 * (4 * 2.0 * 4096 * 512 * 512 + 4.0 * 4096 ** 2 * 512)
    assert dec_attn == enc_attn / 2
    assert not hasattr(module, "flash_attention_calls")


# ---------------------------------------------------------------------------
# the tiny cell through the harness
# ---------------------------------------------------------------------------

# a copy of kl.py whose decode negates the image
FLIPPED = '''
from .kl import *  # noqa: F401,F403
from .kl import AutoencoderKL as _KL
from . import kl as _kl


class AutoencoderKL(_KL):
    def decode(self, z):
        return -super().decode(z)


def models(cfg):
    out = _kl.models(cfg)
    out["vae"] = AutoencoderKL(cfg["vae"])
    return out
'''


def kl_limit() -> float:
    check = json.loads((BENCH / f"checks/{CELL}.json").read_text())
    return check["limits"]["frame_rms_max"]


@pytest.mark.parametrize("module", ["kl", "flipped"])
def test_tiny_kl_cell_rehearsal(tmp_path, monkeypatch, module):
    """The narrowed KL configuration through ``run_cell`` on the CPU, held
    to the KL cell's limit: its own reference reads correct; a reference
    whose decode flips the sign reads incorrect."""
    monkeypatch.setattr(port_builder, "VAEConfig", narrow_vae_config)
    cfg = dict(narrow_config(), reference=f"{module}.py")
    root = bench_tiny_cell.make_root(tmp_path, cfg, limit=kl_limit(), compare_calls=6)
    if module == "flipped":
        (root / "benchmark/reference/flipped.py").write_text(FLIPPED)
    result = harness.run_cell(root, "tiny-64", 2147483647, WINDOW_S, False, "cpu",
                              time.perf_counter(), log=lambda _msg: None)
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["correct"] == (module == "kl"), result["check"]
    if module == "kl":
        assert result["check"]["frame_rms_max"]["value"] < 0.5


LOADS = """
import json, sys
sys.path[:0] = [{tests!r}, {bench!r}]
import torch
import bench_tiny_cell
from reference import stream
cfg = json.loads({cfg!r})
models = stream.build(cfg, "cpu")
for m in models.values():
    for p in m.parameters():
        torch.nn.init.normal_(p, 0.0, 0.05)
s = stream.RefStream(cfg, models, 64, 64, 1, "cpu")
s.prepare(torch.zeros(8, 64, 64, 3, dtype=torch.uint8), torch.zeros(1, 77, 768))
s.step(torch.zeros(64, 64, 3, dtype=torch.uint8))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_kl_reference_loads_nothing_of_the_program():
    """The module, through ``reference.stream`` as the harness loads it,
    in a fresh process: neither JAX nor the JAX package nor the program."""
    cfg = json.dumps(dict(narrow_config(), reference=str(BENCH / "reference/kl.py")))
    script = LOADS.format(tests=str(BENCH / "tests"), bench=str(BENCH), cfg=cfg)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not {"jax", "jaxlib", "flax", "live2diff_tpu", "live2diff_tpu_torch"} & top
    assert "torch" in top

