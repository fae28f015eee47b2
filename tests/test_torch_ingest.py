"""The port's checkpoint readers, LDM remap, LoRA merge and textual
inversion against the JAX package's on the same inputs.

* ``read_safetensors`` (a reader of the format, no ``safetensors`` package)
  against files the ``safetensors`` package writes: every dtype it takes,
  the metadata and a zero-size tensor, bit for bit.
* torch pickles (zip and legacy), with a ``state_dict`` wrapper and
  non-tensor entries, against the JAX package's own pickle reader.
* ``convert/ldm.py``, ``lora.py`` (three key dialects, linear and 3x3 conv,
  the ``collect`` records and ``lora_delta_state_dict``) and
  ``textual_inversion.py``, each with equal keys and equal arrays: the
  remap moves arrays unchanged; the LoRA merge computes the JAX merge's
  fp32 products in the same order, so its results are compared exactly.
  A 1x1 conv LoRA, which the JAX merge refuses (its einsum repeats an
  output subscript), is held to the direct product.
* a checkpoint written in fp32 and loaded into a bf16 build: every
  parameter is bf16, and each one the file names equals the file's value
  rounded to bf16 once.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from safetensors.torch import save_file as torch_save_file

from _torch_checkpoints import (
    TINY_OVERRIDES, config_without_paths, draw, module_shapes, save_file, write_checkpoints,
)
from _torch_parity import TINY_DPT
from live2diff_tpu.convert.ldm import convert_ldm_checkpoint as jax_convert_ldm
from live2diff_tpu.convert.lora import lora_delta_state_dict as jax_lora_delta
from live2diff_tpu.convert.lora import merge_lora_into_state_dict as jax_merge
from live2diff_tpu.convert.textual_inversion import (
    apply_textual_inversion as jax_apply_ti, extract_ti_embeddings as jax_extract_ti,
)
from live2diff_tpu.convert.torch_to_flax import load_state_dict_file as jax_load
from live2diff_tpu.utils.tokenizer import CLIPTokenizer as JaxTokenizer
from live2diff_tpu_torch.builder import build_module, build_pipeline
from live2diff_tpu_torch.convert.ldm import convert_ldm_checkpoint
from live2diff_tpu_torch.convert.lora import lora_delta_state_dict, merge_lora_into_state_dict
from live2diff_tpu_torch.convert.state_dict import load_state_dict_file, read_safetensors
from live2diff_tpu_torch.convert.textual_inversion import (
    apply_textual_inversion, extract_ti_embeddings,
)
from live2diff_tpu_torch.models.midas import DPTConfig, DPTDepthModel
from live2diff_tpu_torch.models.text_encoder import CLIPTextConfig, CLIPTextModelWithFinalNorm
from live2diff_tpu_torch.utils.tokenizer import CLIPTokenizer
from test_torch_text import TINY_CLIP

SAFETENSORS_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32,
                      torch.bool, torch.float64, torch.int8, torch.uint8, torch.int16]


def _tensor(dtype, shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 3).to(dtype)
    return torch.randint(-100 if dtype != torch.uint8 else 0, 100, shape, generator=g,
                         dtype=torch.int64).to(dtype)


@pytest.mark.parametrize("dtype", SAFETENSORS_DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_safetensors_reader_matches_the_package(tmp_path, dtype):
    from safetensors.torch import load_file

    sd = {"a.weight": _tensor(dtype, (3, 5, 2)), "b": _tensor(dtype, (7,), seed=1),
          "empty": _tensor(dtype, (0, 4)), "scalar": _tensor(dtype, (), seed=2)}
    path = str(tmp_path / "x.safetensors")
    torch_save_file(sd, path, metadata={"format": "pt", "note": "synthetic"})
    ours, meta = read_safetensors(path)
    ref = load_file(path)
    assert meta == {"format": "pt", "note": "synthetic"}
    assert set(ours) == set(ref) == set(sd)
    for k, v in ours.items():
        assert v.dtype == ref[k].dtype == dtype and v.shape == ref[k].shape
        assert torch.equal(v, ref[k])
    assert load_state_dict_file(path).keys() == sd.keys()


def test_safetensors_reader_matches_numpy_files_and_the_jax_loader(tmp_path):
    from safetensors.numpy import save_file

    rs = np.random.RandomState(0)
    sd = {"x": rs.randn(4, 3).astype(np.float32), "y": rs.randn(2).astype(np.float16),
          "z": np.arange(6, dtype=np.int64).reshape(2, 3), "w": np.zeros((0,), np.int32)}
    path = str(tmp_path / "n.safetensors")
    save_file(sd, path)
    ours, meta = read_safetensors(path)
    ref = jax_load(path)
    assert meta == {} and set(ours) == set(ref) == set(sd)
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), ref[k])
        assert v.numpy().dtype == ref[k].dtype


def test_safetensors_reader_refuses_a_truncated_file(tmp_path):
    path = tmp_path / "t.safetensors"
    torch_save_file({"a": torch.ones(100)}, str(path))
    data = path.read_bytes()
    path.write_bytes(data[:-10])
    with pytest.raises(ValueError):
        read_safetensors(str(path))


def _pickle_sd():
    g = torch.Generator().manual_seed(3)
    return {"conv.weight": torch.randn(4, 3, 3, 3, generator=g),
            "lin.bias": torch.randn(4, generator=g).half(),
            "steps": torch.tensor(7), "flag": torch.tensor([True, False])}


@pytest.mark.parametrize("zipfile", [True, False], ids=["zip", "legacy"])
@pytest.mark.parametrize("wrapped", [False, True], ids=["flat", "state_dict"])
def test_torch_pickles_match_the_jax_reader(tmp_path, zipfile, wrapped):
    sd = _pickle_sd()
    obj = {"state_dict": sd, "global_step": 10, "name": "x"} if wrapped else \
        dict(sd, note="not a tensor")
    path = str(tmp_path / "m.ckpt")
    torch.save(obj, path, _use_new_zipfile_serialization=zipfile)
    ours = load_state_dict_file(path)
    ref = jax_load(path)
    assert set(ours) == set(ref) == set(sd)
    for k, v in ours.items():
        assert torch.equal(v, sd[k])
        np.testing.assert_array_equal(v.numpy(), ref[k])


def test_torch_load_runs_no_code(tmp_path):
    class Evil:
        def __reduce__(self):
            return (print, ("this must not run",))

    path = str(tmp_path / "evil.pt")
    torch.save({"w": torch.ones(2), "x": Evil()}, path)
    with pytest.raises(Exception):
        load_state_dict_file(path)


# ---------------------------------------------------------------------------
# LDM remap
# ---------------------------------------------------------------------------


def _ldm_keys():
    u, v, c = "model.diffusion_model.", "first_stage_model.", "cond_stage_model.transformer."
    keys = [u + "time_embed.0.weight", u + "time_embed.2.bias", u + "input_blocks.0.0.weight",
            u + "out.0.weight", u + "out.2.bias"]
    for i in range(1, 12):
        if i in (3, 6, 9):
            keys.append(u + f"input_blocks.{i}.0.op.weight")
            continue
        for tail in ("in_layers.0.weight", "in_layers.2.bias", "emb_layers.1.weight",
                     "out_layers.0.bias", "out_layers.3.weight", "skip_connection.weight"):
            keys.append(u + f"input_blocks.{i}.0.{tail}")
        keys += [u + f"input_blocks.{i}.1.proj_in.weight",
                 u + f"input_blocks.{i}.1.transformer_blocks.0.attn2.to_k.weight"]
    for unit in (0, 2):
        keys.append(u + f"middle_block.{unit}.out_layers.3.weight")
    keys.append(u + "middle_block.1.transformer_blocks.0.ff.net.0.proj.weight")
    for i in range(12):
        keys += [u + f"output_blocks.{i}.0.in_layers.0.weight",
                 u + f"output_blocks.{i}.1.norm.weight"]
    keys += [u + "output_blocks.2.1.conv.weight", u + "output_blocks.5.2.conv.bias",
             u + "output_blocks.8.2.conv.weight"]
    for t in ("encoder", "decoder"):
        keys += [v + f"{t}.conv_in.weight", v + f"{t}.norm_out.bias",
                 v + f"{t}.mid.block_1.norm1.weight", v + f"{t}.mid.block_2.nin_shortcut.weight"]
        for name in ("norm", "q", "k", "v", "proj_out"):
            keys.append(v + f"{t}.mid.attn_1.{name}.weight")
    keys += [v + "encoder.down.1.block.0.nin_shortcut.weight",
             v + "encoder.down.2.downsample.conv.bias", v + "decoder.up.0.block.2.conv1.weight",
             v + "decoder.up.3.upsample.conv.weight", v + "quant_conv.weight",
             v + "post_quant_conv.bias"]
    keys += [c + "text_model.encoder.layers.0.mlp.fc1.weight",
             c + "text_model.final_layer_norm.bias", "model_ema.decay", "alphas_cumprod"]
    return keys


def test_ldm_remap_matches_jax():
    rs = np.random.RandomState(0)
    sd = {}
    for k in _ldm_keys():
        four = ".mid.attn_1." in k and not k.split(".")[-2] == "norm"
        sd[k] = rs.randn(*((3, 2, 1, 1) if four else (3, 2))).astype(np.float32)
    ours = convert_ldm_checkpoint({k: torch.from_numpy(v) for k, v in sd.items()})
    ref = jax_convert_ldm(sd)
    for part, (o, r) in zip(("unet", "vae", "clip"), zip(ours, ref)):
        assert set(o) == set(r), part
        assert len(o) > 0, part
        for k in o:
            np.testing.assert_array_equal(o[k].numpy(), r[k], err_msg=k)
    assert "decoder.mid_block.attentions.0.to_q.weight" in ours[1]
    assert ours[1]["decoder.mid_block.attentions.0.to_q.weight"].shape == (3, 2)


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------


def _base_state_dicts(rs):
    unet = {"conv_in.weight": rs.randn(8, 4, 3, 3), "conv_in.bias": rs.randn(8),
            "down_blocks.0.attentions.0.proj_in.weight": rs.randn(8, 8, 1, 1),
            "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight": rs.randn(8, 8),
            "mid_block.attentions.0.transformer_blocks.0.attn2.to_k.weight": rs.randn(16, 12),
            "up_blocks.1.attentions.0.transformer_blocks.0.ff.net.2.weight": rs.randn(16, 64)}
    text = {"text_model.encoder.layers.0.self_attn.q_proj.weight": rs.randn(12, 12),
            "text_model.encoder.layers.1.mlp.fc1.weight": rs.randn(48, 12)}
    cast = lambda d: {k: v.astype(np.float32) for k, v in d.items()}  # noqa: E731
    return cast(unet), cast(text)


def _lora_sd(rs):
    f = lambda *s: (0.1 * rs.randn(*s)).astype(np.float32)  # noqa: E731
    k1 = "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q"
    k2 = "lora_te_text_model_encoder_layers_0_self_attn_q_proj"
    k3 = "unet.mid_block.attentions.0.transformer_blocks.0.attn2.to_k"
    k4 = "text_encoder.text_model.encoder.layers.1.mlp.fc1"
    k5 = "up_blocks.1.attentions.0.transformer_blocks.0.ff.net.2.base_layer"
    return {
        # kohya: 3x3 conv LoRA with alpha, linear with and without alpha
        "lora_unet_conv_in.lora_up.weight": f(8, 4, 1, 1),
        "lora_unet_conv_in.lora_down.weight": f(4, 4, 3, 3),
        "lora_unet_conv_in.alpha": np.asarray(2.0, np.float32),
        f"{k1}.lora_up.weight": f(8, 2), f"{k1}.lora_down.weight": f(2, 8),
        f"{k1}.alpha": np.asarray(1.0, np.float32),
        f"{k2}.lora_up.weight": f(12, 4), f"{k2}.lora_down.weight": f(4, 12),
        # diffusers/peft lora_A/lora_B, with a prefix, and with .base_layer and none
        f"{k3}.lora_B.weight": f(16, 4), f"{k3}.lora_A.weight": f(4, 12),
        f"{k5}.lora_B.weight": f(16, 4), f"{k5}.lora_A.weight": f(4, 64),
        # lora_linear_layer
        f"{k4}.lora_linear_layer.up.weight": f(48, 4),
        f"{k4}.lora_linear_layer.down.weight": f(4, 12),
        # unmatched: no target, and an up without a down
        "lora_unet_no_such_module.lora_up.weight": f(2, 2),
        "lora_unet_no_such_module.lora_down.weight": f(2, 2),
        "lora_unet_lonely.lora_up.weight": f(2, 2),
    }


def _torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def test_lora_merge_matches_jax():
    rs = np.random.RandomState(0)
    unet, text = _base_state_dicts(rs)
    lora = _lora_sd(rs)
    t_unet, t_text = _torch(unet), _torch(text)
    j_records, t_records = [], []
    ref = jax_merge(unet, text, lora, lora_alpha=0.7, collect=j_records)
    ours = merge_lora_into_state_dict(t_unet, t_text, _torch(lora), lora_alpha=0.7,
                                      collect=t_records)
    assert ours == ref == (6, 2)
    for t, j in ((t_unet, unet), (t_text, text)):
        assert set(t) == set(j)
        for k in t:
            np.testing.assert_array_equal(t[k].numpy(), j[k], err_msg=k)
    assert len(t_records) == len(j_records) == 6
    for (tw, tk, tu, td, tunit), (jw, jk, ju, jd, junit) in zip(t_records, j_records):
        assert (tw, tk, tunit) == (jw, jk, junit)
        np.testing.assert_array_equal(tu.numpy(), ju)
        np.testing.assert_array_equal(td.numpy(), jd)
    for t_d, j_d in zip(lora_delta_state_dict(t_records, -0.45),
                        jax_lora_delta(j_records, -0.45)):
        assert set(t_d) == set(j_d)
        for k in t_d:
            assert t_d[k].dtype == torch.float32
            np.testing.assert_allclose(t_d[k].numpy(), j_d[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)


def test_lora_keeps_the_state_dict_dtype_and_merges_in_fp32():
    rs = np.random.RandomState(1)
    w = torch.from_numpy(rs.randn(8, 8).astype(np.float32)).to(torch.bfloat16)
    up, down = (torch.from_numpy(rs.randn(*s).astype(np.float32)) for s in ((8, 2), (2, 8)))
    sd = {"a.to_q.weight": w.clone()}
    merge_lora_into_state_dict(sd, {}, {"a.to_q.lora_B.weight": up, "a.to_q.lora_A.weight": down},
                               lora_alpha=0.5)
    assert sd["a.to_q.weight"].dtype == torch.bfloat16
    assert torch.equal(sd["a.to_q.weight"], (w.float() + (0.5 * up) @ down).to(torch.bfloat16))


def test_lora_1x1_conv_equals_the_direct_product():
    rs = np.random.RandomState(2)
    w = torch.from_numpy(rs.randn(8, 6, 1, 1).astype(np.float32))
    up = torch.from_numpy(rs.randn(8, 3, 1, 1).astype(np.float32))
    down = torch.from_numpy(rs.randn(3, 6, 1, 1).astype(np.float32))
    sd, records = {"proj_in.weight": w.clone()}, []
    merge_lora_into_state_dict(sd, {}, {"lora_unet_proj_in.lora_up.weight": up,
                                        "lora_unet_proj_in.lora_down.weight": down,
                                        "lora_unet_proj_in.alpha": torch.tensor(1.5)},
                               lora_alpha=2.0, collect=records)
    direct = w + 2.0 * 0.5 * (up[:, :, 0, 0] @ down[:, :, 0, 0])[:, :, None, None]
    torch.testing.assert_close(sd["proj_in.weight"], direct, rtol=1e-6, atol=1e-6)
    unet_d, text_d = lora_delta_state_dict(records, -2.0)
    torch.testing.assert_close(sd["proj_in.weight"] + unet_d["proj_in.weight"], w,
                               rtol=1e-6, atol=1e-6)
    assert text_d == {}


# ---------------------------------------------------------------------------
# textual inversion
# ---------------------------------------------------------------------------


TI_LAYOUTS = {
    "emb_params": lambda rs: {"emb_params": rs.randn(2, 16).astype(np.float32)},
    "single_vector": lambda rs: {"emb_params": rs.randn(1, 16).astype(np.float32)},
    "string_to_param": lambda rs: {"string_to_param": {"*": rs.randn(3, 16).astype(np.float32)}},
    "flat_one": lambda rs: {"MyStyle": rs.randn(16).astype(np.float32)},
    "flat_many": lambda rs: {"tok_a": rs.randn(16).astype(np.float32),
                             "tok_b": rs.randn(1, 16).astype(np.float32)},
}


@pytest.mark.parametrize("layout", sorted(TI_LAYOUTS))
def test_textual_inversion_matches_jax(layout):
    rs = np.random.RandomState(4)
    sd = TI_LAYOUTS[layout](rs)
    jtok, ttok = JaxTokenizer.tiny(model_max_length=77), CLIPTokenizer.tiny(model_max_length=77)
    # a table with a row for every token, as a real vocabulary has
    table = rs.randn(len(jtok.encoder), 16).astype(np.float32)
    t_sd = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else torch.from_numpy(v)) for k, v in sd.items()}
    ref_pairs = jax_extract_ti(sd, "Emb")
    pairs = extract_ti_embeddings(t_sd, "Emb")
    assert [n for n, _ in pairs] == [n for n, _ in ref_pairs]
    for (_, a), (_, b) in zip(pairs, ref_pairs):
        np.testing.assert_array_equal(a.numpy(), b)
    params = {"params": {"text_model": {"token_embedding": {"embedding": table.copy()}}}}
    jtok, params = jax_apply_ti(jtok, params, sd, "Emb")
    ttok, ttable = apply_textual_inversion(ttok, torch.from_numpy(table.copy()), t_sd, "Emb")
    assert ttok.encoder == jtok.encoder and ttok.added_tokens == jtok.added_tokens
    np.testing.assert_array_equal(
        ttable.numpy(), params["params"]["text_model"]["token_embedding"]["embedding"])
    # a second application adds nothing: the tokens exist
    ttok, again = apply_textual_inversion(ttok, ttable, t_sd, "Emb")
    assert again.shape == ttable.shape


# ---------------------------------------------------------------------------
# an fp32 file into a bf16 build
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def bf16_pipeline(tmp_path_factory):
    """The tiny UNet, its motion module and TAESD, built in bf16 by
    ``build_pipeline`` from the fp32 files ``write_checkpoints`` writes (no
    DreamBooth, LoRA or LCM-LoRA, which would change the values)."""
    cfg = write_checkpoints(tmp_path_factory.mktemp("fp32"))
    built = build_pipeline({**config_without_paths(cfg), "third_party_dict": {}}, 64, 64,
                           dtype=BF16, device="cpu", use_depth=False, use_lcm_lora=False,
                           unet_overrides=TINY_OVERRIDES)
    return cfg, built


def _file(path, keep=lambda k: True):
    """A checkpoint as the builder reads it, with the keys ``keep`` takes."""
    sd = load_state_dict_file(str(path))
    return {k.removeprefix("module."): v for k, v in sd.items() if keep(k)}


def _built_alone(tmp_path, make, name):
    """``make``'s module written in fp32 to ``name`` under ``tmp_path``, then
    built from that file in bf16 by the builder's ``build_module``."""
    rs = np.random.RandomState(3)
    path = str(tmp_path / name)
    save_file({k: draw(k, s, rs) for k, s in module_shapes(make).items()}, path)
    sd = load_state_dict_file(path)
    missing = []
    module = build_module(make, torch.device("cpu"), BF16, torch.Generator().manual_seed(0),
                          sd, missing)
    assert missing == []
    return sd, module


@pytest.mark.parametrize("kind", ["unet", "motion", "taesd", "dpt", "text"])
def test_an_fp32_checkpoint_loads_as_its_bf16_rounding(bf16_pipeline, tmp_path, kind):
    cfg, built = bf16_pipeline
    if kind == "unet":
        sd = _file(f"{cfg['pretrained_model_path']}/unet/diffusion_pytorch_model.safetensors")
        module = built.unet
    elif kind == "motion":
        sd = _file(cfg["motion_module_path"], keep=lambda k: k.split(".")[-1] not in (
            "grid", "pe"))
        module = built.unet
    elif kind == "taesd":
        sd, module = _file(cfg["taesd_path"]), built.vae
    elif kind == "dpt":
        sd, module = _built_alone(tmp_path, lambda: DPTDepthModel(DPTConfig(**TINY_DPT)),
                                  "dpt_hybrid_384.pt")
    else:
        sd, module = _built_alone(
            tmp_path, lambda: CLIPTextModelWithFinalNorm(CLIPTextConfig(**TINY_CLIP)),
            "model.safetensors")
    params = dict(module.named_parameters())
    assert {k: p.dtype for k, p in params.items() if p.dtype != BF16} == {}
    assert sd and set(sd) <= set(params)
    assert {v.dtype for v in sd.values()} == {torch.float32}
    # the file's values are not bf16 numbers, so the rounding shows
    assert any(not torch.equal(v.to(BF16).float(), v) for v in sd.values())
    for k, v in sd.items():
        assert torch.equal(params[k], v.to(BF16)), k
