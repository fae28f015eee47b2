"""The port's CLIP tokenizer and text encoder against the JAX package's.

* Token ids, equal over a fixed list of strings (unicode, CJK,
  punctuation, contractions, numbers, whitespace, an over-length string
  that is truncated to 77, added textual-inversion tokens), with
  ``tiny()`` and with a synthetic ``vocab.json`` / ``merges.txt`` folder.
* A tiny ``CLIPTextConfig`` encoder on one HF-layout state dict: the JAX
  model through ``clip_torch_to_flax``, the port's loaded by name; fp32,
  at clip_skip 0, 1 and 2, within 1e-5 relative (the same fp32 math in
  another order).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from live2diff_tpu.convert.torch_to_flax import clip_torch_to_flax
from live2diff_tpu.models.text_encoder import CLIPTextConfig as JaxCLIPTextConfig
from live2diff_tpu.models.text_encoder import CLIPTextModelWithFinalNorm as JaxCLIP
from live2diff_tpu.utils.tokenizer import CLIPTokenizer as JaxTokenizer
from live2diff_tpu_torch.convert.checkpoint import load_into
from live2diff_tpu_torch.models.text_encoder import CLIPTextConfig, CLIPTextModelWithFinalNorm
from live2diff_tpu_torch.utils.tokenizer import CLIPTokenizer, bytes_to_unicode

STRINGS = [
    "a cat in the rain",
    "Masterpiece, best quality, intricate, print, pattern, a cat",
    "naïve café über Straße",
    "日本語のテキストと한국어",
    "it's a dog's life, isn't it? we'll see; they'd know",
    "numbers 12345 and 3.14 or 1e-5",
    "   spaces\tand\nnewlines   nbsp  ",
    "emoji 🐱🐶 and !!!??? ... --- ***",
    "<|startoftext|> special <|endoftext|> tokens",
    "word " * 100,
    "",
    "easynegative_0 portrait, EasyNegative_1 by artist",
]
WORDS = ["cat", "rain", "the", "masterpiece", "best", "quality", "in", "and", "caf", "dog"]
CLIP_TOL = 1e-5


def _write_vocab(folder):
    """A byte vocabulary plus the merges that build each word of WORDS."""
    vocab = {c: i for i, c in enumerate(bytes_to_unicode().values())}
    vocab.update({c + "</w>": len(vocab) + i for i, c in enumerate(bytes_to_unicode().values())})
    merges = []
    for word in WORDS:
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            pair = (parts[0], parts[1])
            if pair not in merges:
                merges.append(pair)
            parts = [parts[0] + parts[1]] + parts[2:]
            vocab.setdefault(parts[0], len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (folder / "tokenizer").mkdir()
    (folder / "tokenizer" / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    lines = ["#version: 0.2"] + [f"{a} {b}" for a, b in merges]
    (folder / "tokenizer" / "merges.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("sd")
    _write_vocab(d)
    return d


def _pair(kind, vocab_dir):
    if kind == "tiny":
        return CLIPTokenizer.tiny(model_max_length=77), JaxTokenizer.tiny(model_max_length=77)
    return CLIPTokenizer.from_pretrained(str(vocab_dir)), JaxTokenizer.from_pretrained(
        str(vocab_dir))


@pytest.mark.parametrize("kind", ["tiny", "vocab_dir"])
@pytest.mark.parametrize("text", STRINGS, ids=range(len(STRINGS)))
def test_token_ids_equal_jax(vocab_dir, kind, text):
    ours, ref = _pair(kind, vocab_dir)
    for tok in ("easynegative_0", "easynegative_1"):
        ours.add_token(tok, len(ours.encoder))
        ref.add_token(tok, len(ref.encoder))
    ids, ref_ids = ours([text]), ref([text])
    assert ids.shape == (1, 77) and ids.dtype == np.int32
    np.testing.assert_array_equal(ids, ref_ids)
    assert ids[0, 0] == ours.bos_token_id
    assert (ids == ours.eos_token_id).any()


def test_merges_shorten_the_ids(vocab_dir):
    tok = CLIPTokenizer.from_pretrained(str(vocab_dir))
    n_bpe = int((tok(["masterpiece cat"]) != tok.pad_token_id).sum())
    n_bytes = int((CLIPTokenizer.tiny(77)(["masterpiece cat"]) != tok.pad_token_id).sum())
    assert n_bpe == 3 < n_bytes  # BOS and two merged words (EOS is the pad id)


TINY_CLIP = dict(vocab_size=600, hidden_size=32, num_layers=3, num_heads=4,
                 intermediate_size=64, max_position_embeddings=77)


def _hf_state_dict(cfg: dict, seed: int = 0):
    rs = np.random.RandomState(seed)
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    sd = {"text_model.embeddings.token_embedding.weight": rs.randn(cfg["vocab_size"], h),
          "text_model.embeddings.position_embedding.weight": 0.1 * rs.randn(77, h),
          "text_model.embeddings.position_ids": np.arange(77)[None],  # unused buffer
          "text_model.final_layer_norm.weight": 1 + 0.1 * rs.randn(h),
          "text_model.final_layer_norm.bias": 0.1 * rs.randn(h)}
    for i in range(cfg["num_layers"]):
        p = f"text_model.encoder.layers.{i}"
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{p}.self_attn.{nm}.weight"] = rs.randn(h, h) / np.sqrt(h)
            sd[f"{p}.self_attn.{nm}.bias"] = 0.05 * rs.randn(h)
        for nm in ("layer_norm1", "layer_norm2"):
            sd[f"{p}.{nm}.weight"] = 1 + 0.1 * rs.randn(h)
            sd[f"{p}.{nm}.bias"] = 0.1 * rs.randn(h)
        sd[f"{p}.mlp.fc1.weight"] = rs.randn(f, h) / np.sqrt(h)
        sd[f"{p}.mlp.fc1.bias"] = 0.05 * rs.randn(f)
        sd[f"{p}.mlp.fc2.weight"] = rs.randn(h, f) / np.sqrt(f)
        sd[f"{p}.mlp.fc2.bias"] = 0.05 * rs.randn(h)
    return {k: v.astype(np.float32) if v.dtype.kind == "f" else v for k, v in sd.items()}


@pytest.fixture(scope="module")
def encoders():
    sd = _hf_state_dict(TINY_CLIP)
    jmodel = JaxCLIP(config=JaxCLIPTextConfig(**TINY_CLIP), dtype=jnp.float32)
    converted, skipped = clip_torch_to_flax(sd)
    assert skipped == ["text_model.embeddings.position_ids"]
    tmodel = CLIPTextModelWithFinalNorm(CLIPTextConfig(**TINY_CLIP)).eval()
    missing = []
    load_into(tmodel, {k: torch.from_numpy(v) for k, v in sd.items()}, missing)
    assert missing == []
    return jmodel, converted, tmodel


@pytest.mark.parametrize("clip_skip", [0, 1, 2])
def test_text_encoder_equals_jax(encoders, clip_skip):
    jmodel, params, tmodel = encoders
    ids = CLIPTokenizer.tiny(model_max_length=77)(["a cat in the rain", "masterpiece, 日本"])
    ref = np.asarray(jax.jit(lambda p, i: jmodel.apply(p, i, clip_skip=clip_skip))(
        params, jnp.asarray(ids)))
    with torch.no_grad():
        ours = tmodel(torch.from_numpy(ids.astype(np.int64)), clip_skip=clip_skip).numpy()
    assert ours.shape == ref.shape == (2, 77, TINY_CLIP["hidden_size"])
    assert rel_err(ours, ref) < CLIP_TOL


def test_clip_skip_picks_an_earlier_layer(encoders):
    _, _, tmodel = encoders
    ids = torch.from_numpy(CLIPTokenizer.tiny(77)(["a cat"]).astype(np.int64))
    with torch.no_grad():
        outs = [tmodel(ids, clip_skip=k) for k in (0, 1, 2)]
    assert not torch.allclose(outs[0], outs[1]) and not torch.allclose(outs[1], outs[2])
