"""Self-contained CLIP byte-level BPE tokenizer (pure Python).

Port of ``live2diff_tpu/utils/tokenizer.py``: the ids of
``transformers.CLIPTokenizer`` without that package. Byte-level BPE with
``</w>`` end-of-word markers, lowercasing and CLIP's special tokens; the
vocabulary and merges load from the standard ``tokenizer/vocab.json`` and
``merges.txt`` of an SD checkpoint directory, and ``tiny()`` makes a byte
vocabulary with no merges where none is on disk.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

# CLIP's pre-tokenizer pattern (transformers CLIPTokenizer / openai CLIP):
#   <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+
# Python's stdlib `re` has no \p{L}/\p{N} classes, so `_clip_token_split`
# scans full Unicode categories (unicodedata): maximal letter runs (L*),
# SINGLE number chars (N*), and maximal runs of everything else that is not
# whitespace. That is what the regex matches: its alternation is tried left
# to right at each position and the classes are disjoint.

_SPECIAL_TOKENS = ("<|startoftext|>", "<|endoftext|>")
# regex alternation order (first match wins at a given position)
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


def _clip_token_split(text: str) -> List[str]:
    """Split ``text`` exactly as CLIP's pre-tokenizer regex would."""
    tokens: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch.isspace():
            i += 1
            continue
        matched = False
        for sp in _SPECIAL_TOKENS:
            if text[i:i + len(sp)].lower() == sp:
                tokens.append(text[i:i + len(sp)])
                i += len(sp)
                matched = True
                break
        if matched:
            continue
        if ch == "'":
            for c in _CONTRACTIONS:
                if text[i:i + len(c)].lower() == c:
                    tokens.append(text[i:i + len(c)])
                    i += len(c)
                    matched = True
                    break
            if matched:
                continue
        if _is_letter(ch):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(ch):
            j = i + 1  # [\p{N}] matches a single char
        else:
            j = i + 1
            while j < n:
                c = text[j]
                if c.isspace() or _is_letter(c) or _is_number(c):
                    break
                j += 1
        tokens.append(text[i:j])
        i = j
    return tokens


# -- normalization: transformers.CLIPTokenizer's no-ftfy path ---------------
# The deployed tokenizer (bare `transformers`) runs WITHOUT ftfy and normalizes through
# BasicTokenizer(strip_accents=False, do_split_on_punc=False):
# control-char removal, CJK char isolation, NFC, whitespace split,
# per-token lowercase, rejoin (transformers tokenization_clip.py _tokenize).
# We replicate that path exactly for token-id parity.

_CJK_RANGES = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
    (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
    (0xF900, 0xFAFF), (0x2F800, 0x2FA1F),
)


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_ws(ch: str) -> bool:
    return ch in (" ", "\t", "\n", "\r") or unicodedata.category(ch) == "Zs"


def clip_normalize(text: str) -> str:
    """Normalize as transformers' CLIPTokenizer does without ftfy."""
    cleaned = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_ws(ch):
            cleaned.append(" ")
        elif _is_cjk(cp):
            cleaned.append(f" {ch} ")
        else:
            cleaned.append(ch)
    text = unicodedata.normalize("NFC", "".join(cleaned))
    return " ".join(tok.lower() for tok in text.split())


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 style reversible byte<->unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class CLIPTokenizer:
    """CLIP BPE tokenizer (49408 tokens, 77-token context for SD-1.5)."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 model_max_length: int = 77):
        self.encoder = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.model_max_length = model_max_length
        self.bos_token = "<|startoftext|>"
        self.eos_token = "<|endoftext|>"
        self.bos_token_id = vocab[self.bos_token]
        self.eos_token_id = vocab[self.eos_token]
        self.pad_token_id = self.eos_token_id
        self.cache: Dict[str, str] = {
            self.bos_token: self.bos_token, self.eos_token: self.eos_token
        }
        # textual-inversion / user-added tokens, matched before BPE
        self.added_tokens: Dict[str, int] = {}

    # -- construction -------------------------------------------------------

    @classmethod
    def from_pretrained(cls, path: str, **kwargs) -> "CLIPTokenizer":
        """Load from an SD checkpoint dir (``<path>/vocab.json``/``merges.txt``
        or ``<path>/tokenizer/...``)."""
        for sub in ("", "tokenizer"):
            vpath = os.path.join(path, sub, "vocab.json")
            mpath = os.path.join(path, sub, "merges.txt")
            if os.path.isfile(vpath) and os.path.isfile(mpath):
                with open(vpath, encoding="utf-8") as f:
                    vocab = json.load(f)
                with open(mpath, encoding="utf-8") as f:
                    lines = f.read().split("\n")
                merges = [tuple(l.split()) for l in lines if l and not l.startswith("#version")]
                merges = [m for m in merges if len(m) == 2]
                return cls(vocab, merges, **kwargs)
        raise FileNotFoundError(f"no vocab.json/merges.txt under {path}")

    @classmethod
    def tiny(cls, model_max_length: int = 16) -> "CLIPTokenizer":
        """A minimal synthetic vocab for tests (byte alphabet, no merges)."""
        byte_vocab = list(bytes_to_unicode().values())
        vocab = {c: i for i, c in enumerate(byte_vocab)}
        n = len(vocab)
        for i, c in enumerate(byte_vocab):
            vocab[c + "</w>"] = n + i
        vocab["<|startoftext|>"] = len(vocab)
        vocab["<|endoftext|>"] = len(vocab)
        return cls(vocab, [], model_max_length=model_max_length)

    # -- BPE ----------------------------------------------------------------

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word[:-1], word[1:]))
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = set(zip(word[:-1], word[1:]))
        out = " ".join(word)
        self.cache[token] = out
        return out

    def add_token(self, token: str, token_id: int) -> None:
        """Register an atomic (textual-inversion) token."""
        self.added_tokens[token] = token_id
        self.encoder[token] = token_id
        self.decoder[token_id] = token

    def tokenize(self, text: str) -> List[int]:
        text = clip_normalize(text)
        ids: List[int] = []
        # split on added tokens first so they stay atomic
        segments = [text]
        for tok in sorted(self.added_tokens, key=len, reverse=True):
            new_segments: List = []
            for seg in segments:
                if isinstance(seg, int):
                    new_segments.append(seg)
                    continue
                parts = seg.split(tok.lower())
                for i, part in enumerate(parts):
                    if i:
                        new_segments.append(self.added_tokens[tok])
                    if part:
                        new_segments.append(part)
            segments = new_segments
        for seg in segments:
            if isinstance(seg, int):
                ids.append(seg)
                continue
            for token in _clip_token_split(seg):
                token_bytes = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
                for bpe_token in self._bpe(token_bytes).split(" "):
                    ids.append(self.encoder.get(bpe_token, self.eos_token_id))
        return ids

    # -- public API ---------------------------------------------------------

    def __call__(
        self,
        texts: Sequence[str] | str,
        padding: str = "max_length",
        max_length: int | None = None,
        truncation: bool = True,
    ) -> np.ndarray:
        """Encode to ``[batch, max_length]`` int32 ids with BOS/EOS/pad."""
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        out = np.full((len(texts), max_length), self.pad_token_id, dtype=np.int32)
        for row, text in enumerate(texts):
            ids = [self.bos_token_id] + self.tokenize(text)
            ids = ids[: max_length - 1] + [self.eos_token_id]
            out[row, : len(ids)] = ids
        return out

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(
            self.decoder.get(int(i), "") for i in ids
            if int(i) not in (self.bos_token_id, self.eos_token_id)
        )
        raw = bytearray(self.byte_decoder.get(c, 32) for c in text.replace("</w>", " "))
        return raw.decode("utf-8", errors="replace").strip()
