"""The port's warm start (live2diff_tpu_torch/aot.py), on the CPU.

* ``engine_key`` names the toolchain and the card, and nothing of the
  pipeline: a library's bytes do not depend on its shapes, and its file
  name already hashes its source and headers.
* ``load_engines`` on a CPU stream, or where nothing is primed, is a no-op.
* The manifest: with the card's parts faked (the card's name, the build,
  the library load, the scratch step), a primed directory lists every
  library the process loaded with its sha256, keeps what another
  configuration primed, loads on a hit with no build, passes over a
  library of an edited source, and is refused, with nothing registered and
  no file deleted, for a flipped byte, a wrong key, a leftover temporary
  file or a failed validation.
"""

from __future__ import annotations

import hashlib
import json
import os
import types

import pytest
import torch

from live2diff_tpu_torch import aot
from live2diff_tpu_torch.builder import build_pipeline
from live2diff_tpu_torch.ops import _build
from live2diff_tpu_torch.wrapper import StreamV2VWrapper

TINY = dict(block_out_channels=(8, 16, 16, 16), attention_head_dim=2, norm_num_groups=4,
            motion_num_attention_heads=2)
CONFIG = {"num_inference_steps": 50, "t_index_list": [30, 40],
          "unet_additional_kwargs": {"motion_module_kwargs": {
              "num_attention_heads": 2,
              "attention_kwargs": {"window_size": 16, "sink_size": 8}}}}
KEY = "0123456789abcdef0123"


@pytest.fixture(scope="module")
def stream():
    return build_pipeline(CONFIG, 64, 64, dtype=torch.float32, kv_cache_dtype="int8",
                          output_uint8=True, device="cpu", use_depth=False,
                          unet_overrides=TINY).stream


@pytest.fixture
def card(monkeypatch):
    """``engine_key``'s view of a card, faked: its name and capability."""
    monkeypatch.setattr(aot, "_card", lambda device: ("NVIDIA H100 80GB HBM3", "(9, 0)"))
    return torch.device("cuda")


def test_engine_key_names_the_toolchain_and_the_card(card, monkeypatch):
    base = aot.engine_key(card)
    assert base == aot.engine_key(torch.device("cuda", 0)) == aot.engine_key(card)
    assert len(base) == 20 and int(base, 16) >= 0
    others = []
    for target, name, value in [(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",)),
                                (torch, "__version__", "0.0.1"),
                                (torch.version, "cuda", "0.1"),
                                (aot, "_card", lambda d: ("NVIDIA H200", "(9, 0)")),
                                (aot, "_card", lambda d: ("NVIDIA H100 80GB HBM3", "(8, 0)"))]:
        with monkeypatch.context() as m:
            m.setattr(target, name, value)
            others.append(aot.engine_key(card))
    assert len({base, *others}) == 1 + len(others)


def test_load_engines_is_a_no_op_on_cpu_and_where_nothing_is_primed(stream, tmp_path):
    libs = dict(_build._LIBS)
    assert aot.save_engines(stream, str(tmp_path)) is None
    assert not aot.load_engines(stream, str(tmp_path))
    assert not aot.load_engines(stream, str(tmp_path / "absent"))
    assert os.listdir(tmp_path) == [] and _build._LIBS == libs
    assert not hasattr(stream, "_aot_load_s")


def test_wrapper_on_cpu_misses_and_does_not_prime(tmp_path):
    wrapper = StreamV2VWrapper(CONFIG, height=64, width=64, use_depth=False,
                               use_text_encoder=False, dtype="float32", unet_overrides=TINY,
                               engine_dir=str(tmp_path), device="cpu")
    assert wrapper.aot_hit is False
    assert wrapper.prime_aot() is False
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# the manifest, with the card's parts faked
# ---------------------------------------------------------------------------

SOURCES = ("stream_attention", "flash_attention", "conv3x3")


@pytest.fixture
def fake_card(monkeypatch, tmp_path):
    """A stream that claims a CUDA device, a fixed key, a build that writes
    stand-in libraries (named by a stand-in hash of their source), a
    library load that records its path, a scratch step that loads
    ``steps[0]``'s sources, and an empty library table. Returns (stream,
    engine dir, loaded paths, built names, the sources a step loads)."""
    built_dir = tmp_path / "build"
    built_dir.mkdir()
    edits = {}

    def lib_path(n):
        digest = hashlib.sha256((n + edits.get(n, "")).encode()).hexdigest()[:12]
        return str(built_dir / f"lib{n}-{digest}.so")

    built, loaded, steps = [], [], [list(SOURCES)]

    def fake_build(names):
        out = {}
        for n in names:
            path = lib_path(n)
            with open(path, "wb") as f:
                f.write(f"stand-in library of {n}".encode() * 100)
            built.append(n)
            out[n] = path
        return out

    def fake_cdll(path):
        loaded.append(path)
        return types.SimpleNamespace(_name=path)

    def scratch_step(stream):
        for n in steps[0]:
            _build.load(n)

    monkeypatch.setattr(aot, "engine_key", lambda device: KEY)
    monkeypatch.setattr(_build, "_lib_path", lib_path)
    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(aot, "_scratch_step", scratch_step)
    monkeypatch.setattr(_build, "_LIBS", {})
    stream = types.SimpleNamespace(device=torch.device("cuda"))
    return types.SimpleNamespace(stream=stream, engines=tmp_path / "engines", loaded=loaded,
                                 built=built, steps=steps, edits=edits,
                                 path=tmp_path / "engines" / "aot" / KEY)


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


def _manifest(path):
    return json.loads((path / aot.MANIFEST).read_text())


def test_save_writes_every_library_and_a_manifest_of_their_hashes(fake_card):
    assert aot.save_engines(fake_card.stream, str(fake_card.engines)) == KEY
    path = fake_card.path
    manifest = _manifest(path)
    assert manifest["key"] == KEY and manifest["schema"] == aot.AOT_SCHEMA
    assert set(manifest["files"]) == set(SOURCES) == set(_build.loaded())
    for source, entry in manifest["files"].items():
        data = (path / entry["file"]).read_bytes()
        assert entry["sha256"] == hashlib.sha256(data).hexdigest()
        assert entry["file"] == os.path.basename(_build._lib_path(source))
    assert sorted(os.listdir(path)) == sorted([aot.MANIFEST] + [
        e["file"] for e in manifest["files"].values()])  # no temporary file left


def test_save_keeps_what_another_configuration_primed(fake_card):
    aot.save_engines(fake_card.stream, str(fake_card.engines))
    # another process, whose step loads the LayerNorm and GroupNorm kernels
    _build._LIBS.clear()
    fake_card.steps[0] = ["stream_attention", "layer_norm", "group_norm"]
    aot.save_engines(fake_card.stream, str(fake_card.engines))
    assert set(_manifest(fake_card.path)["files"]) == set(SOURCES) | {"layer_norm", "group_norm"}


def test_a_primed_dir_loads_and_registers_every_library(fake_card):
    stream = fake_card.stream
    aot.save_engines(stream, str(fake_card.engines))
    _build._LIBS.clear()
    del fake_card.built[:], fake_card.loaded[:]
    assert aot.load_engines(stream, str(fake_card.engines))
    assert set(_build._LIBS) == set(SOURCES) and fake_card.built == []  # no build
    assert all(os.path.dirname(p) == str(fake_card.path) for p in fake_card.loaded)
    assert len(fake_card.loaded) == 3
    assert _build.load("conv3x3") is _build._LIBS["conv3x3"]
    assert stream._aot_load_s >= 0


def test_a_library_of_an_edited_source_is_passed_over(fake_card, capsys):
    stream = fake_card.stream
    aot.save_engines(stream, str(fake_card.engines))
    before = _files(fake_card.engines)
    _build._LIBS.clear()
    del fake_card.built[:]
    fake_card.edits["conv3x3"] = "an edit"  # the source's hash, so its library's name, moves
    assert aot.load_engines(stream, str(fake_card.engines))
    assert fake_card.built == ["conv3x3"]  # built at first use by the scratch step
    assert _build.loaded()["conv3x3"] == _build._lib_path("conv3x3")
    assert all(os.path.dirname(_build.loaded()[s]) == str(fake_card.path)
               for s in ("stream_attention", "flash_attention"))
    assert "['conv3x3'] built from other sources" in capsys.readouterr().out
    assert _files(fake_card.engines) == before


def _flip_byte(path):
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0x01
    path.write_bytes(bytes(data))


def _wrong_key(path):
    manifest = _manifest(path)
    manifest["key"] = "f" * 20
    (path / aot.MANIFEST).write_text(json.dumps(manifest))


def _leftover_tmp(path):
    (path / f"libconv3x3-000000000000.so.123{aot.TMP_SUFFIX}").write_bytes(b"torn")


@pytest.mark.parametrize("spoil", ["flipped byte", "wrong key", "leftover tmp",
                                   "validation fails"])
def test_a_spoiled_dir_is_refused_and_kept(fake_card, monkeypatch, spoil, capsys):
    stream, path = fake_card.stream, fake_card.path
    aot.save_engines(stream, str(fake_card.engines))
    if spoil == "flipped byte":
        _flip_byte(next(p for p in path.iterdir() if p.name.startswith("libflash_attention-")))
    elif spoil == "wrong key":
        _wrong_key(path)
    elif spoil == "leftover tmp":
        _leftover_tmp(path)
    else:
        def oom(*a):
            raise RuntimeError("CUDA out of memory")

        monkeypatch.setattr(aot, "_scratch_step", oom)
    before = _files(fake_card.engines)
    _build._LIBS.clear()
    del fake_card.loaded[:]
    earlier = types.SimpleNamespace(_name="built earlier")
    _build._LIBS["layer_norm"] = earlier
    assert not aot.load_engines(stream, str(fake_card.engines))
    assert _files(fake_card.engines) == before  # nothing deleted, nothing rewritten
    assert _build._LIBS == {"layer_norm": earlier}
    assert not hasattr(stream, "_aot_load_s")
    # the key and every hash are checked before any library is loaded
    assert len(fake_card.loaded) == (3 if spoil == "validation fails" else 0)
    assert "refused" in capsys.readouterr().out


def test_a_new_save_clears_a_torn_one(fake_card):
    stream, path = fake_card.stream, fake_card.path
    aot.save_engines(stream, str(fake_card.engines))
    _leftover_tmp(path)
    _flip_byte(next(p for p in path.iterdir() if p.name.startswith("libconv3x3-")))
    assert not aot.load_engines(stream, str(fake_card.engines))
    aot.save_engines(stream, str(fake_card.engines))
    assert aot.load_engines(stream, str(fake_card.engines))
