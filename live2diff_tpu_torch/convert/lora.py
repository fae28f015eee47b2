"""LoRA merging: weight <- weight + scale * (up @ down), on torch state dicts.

Port of ``live2diff_tpu/convert/lora.py``. The merge runs once, in fp32, on
the checkpoint-layout state dicts before they are loaded into the modules
(and so before the cast to the compute dtype); the runtime never sees LoRA.
Linear LoRA, 1x1 and 3x3 conv LoRA (LoCon) and per-module alpha scaling.

Key dialects:
* kohya/civitai: ``lora_unet_<module>_<path>.lora_up.weight`` /
  ``.lora_down.weight`` / ``.alpha`` (prefixes ``lora_unet_`` / ``lora_te_``);
* diffusers/peft (LCM-LoRA): ``<module>.lora_A.weight`` (down) and
  ``lora_B`` (up);
* ``unet.<...>.lora_linear_layer.up.weight`` / ``.down.weight``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch

StateDict = Dict[str, torch.Tensor]
# (which: "unet" | "text", target key, up, down, unit = alpha / rank)
LoraRecord = Tuple[str, str, torch.Tensor, torch.Tensor, float]

_UP = re.compile(r"^(.*)\.(lora_up\.weight|lora_B\.weight|lora_linear_layer\.up\.weight)$")
_DOWN = re.compile(r"^(.*)\.(lora_down\.weight|lora_A\.weight|lora_linear_layer\.down\.weight)$")
_ALPHA = re.compile(r"^(.*)\.alpha$")


def _delta(up: torch.Tensor, down: torch.Tensor, scale: float) -> torch.Tensor:
    """scale * up @ down, fp32; conv LoRA takes up [O, r, 1, 1] and down
    [r, I, kh, kw] to a [O, I, kh, kw] delta."""
    if up.dim() == 4:
        o, r = up.shape[:2]
        _, i, kh, kw = down.shape
        delta = torch.tensordot(up.reshape(o, r), down, dims=([1], [0]))
        return scale * delta.reshape(o, i, kh, kw)
    return scale * (up @ down)


def _normalise_lora_keys(lora_sd: StateDict) -> Dict[str, dict]:
    """Group LoRA tensors by module: {module_key: {up, down, alpha}}; the
    module key keeps its dialect prefix, which routes it to a state dict."""
    groups: Dict[str, dict] = {}
    for key, val in lora_sd.items():
        m = _UP.match(key)
        if m:
            groups.setdefault(m.group(1), {})["up"] = val
            continue
        m = _DOWN.match(key)
        if m:
            groups.setdefault(m.group(1), {})["down"] = val
            continue
        m = _ALPHA.match(key)
        if m:
            groups.setdefault(m.group(1), {})["alpha"] = float(val)
    return groups


def _resolve_target(module_key: str, unet_index: Dict[str, str],
                    text_index: Dict[str, str]) -> Optional[Tuple[str, str]]:
    """A LoRA module key -> ("unet" | "text", the ``.weight`` key it adds to).

    kohya keys flatten "." to "_", so module paths are matched with their
    dots made underscores against an index of the real keys."""
    candidates = []
    for prefix, which, index in (
        ("lora_unet_", "unet", unet_index),
        ("lora_te_", "text", text_index),
        ("unet.", "unet", unet_index),
        ("text_encoder.", "text", text_index),
    ):
        if module_key.startswith(prefix):
            # peft keys may carry a trailing ".base_layer" level
            flat = module_key[len(prefix):].replace(".", "_").removesuffix("_base_layer")
            target = index.get(flat)
            return (which, target) if target else None
        candidates.append((which, index))
    flat = module_key.replace(".", "_").removesuffix("_base_layer")
    for which, index in candidates:
        if flat in index:
            return which, index[flat]
    return None


def _flat_key_index(sd: StateDict) -> Dict[str, str]:
    """underscored module path -> its ``.weight`` key."""
    return {k[: -len(".weight")].replace(".", "_"): k for k in sd if k.endswith(".weight")}


def merge_lora_into_state_dict(
    unet_sd: StateDict,
    text_sd: StateDict,
    lora_sd: StateDict,
    lora_alpha: float = 1.0,
    collect: Optional[List[LoraRecord]] = None,
) -> Tuple[int, int]:
    """Merge a LoRA into ``unet_sd`` and ``text_sd`` in place: each target
    weight is computed in fp32 and stored back in its own dtype.

    Returns (merged modules, unmatched modules). With ``collect``, one
    record ``(which, target_key, up, down, unit)`` is appended per merged
    module (``unit = alpha / rank``, fp32 factors; the merged delta is
    ``lora_alpha * unit * up @ down``): what ``lora_delta_state_dict``
    needs to change the strength later without a rebuild."""
    unet_index = _flat_key_index(unet_sd)
    text_index = _flat_key_index(text_sd)
    merged = unmatched = 0
    for module_key, parts in _normalise_lora_keys(lora_sd).items():
        if "up" not in parts or "down" not in parts:
            unmatched += 1
            continue
        resolved = _resolve_target(module_key, unet_index, text_index)
        if resolved is None:
            unmatched += 1
            continue
        which, target_key = resolved
        sd = unet_sd if which == "unet" else text_sd
        up = parts["up"].float()
        down = parts["down"].float()
        rank = down.shape[0] if down.dim() >= 2 else 1
        alpha = parts.get("alpha", float(rank))
        scale = lora_alpha * alpha / rank
        w = sd[target_key]
        if up.dim() == 4 or w.dim() == 4:
            if up.dim() == 2:  # a linear LoRA on a conv weight
                up = up[:, :, None, None]
                down = down[:, :, None, None] if down.dim() == 2 else down
            delta = _delta(up, down, scale)
        else:
            delta = (scale * up) @ down  # the JAX merge's order of rounding
        sd[target_key] = (w.float() + delta).to(w.dtype)
        if collect is not None:
            collect.append((which, target_key, up, down, alpha / rank))
        merged += 1
    return merged, unmatched


def lora_delta_state_dict(records: List[LoraRecord], delta_alpha: float
                          ) -> Tuple[StateDict, StateDict]:
    """The fp32 weight deltas of a strength change by ``delta_alpha``, keyed
    like the state dicts the records were merged into: (unet, text)."""
    unet_d: StateDict = {}
    text_d: StateDict = {}
    for which, target_key, up, down, unit in records:
        d = _delta(up, down, delta_alpha * unit)
        tgt = unet_d if which == "unet" else text_d
        tgt[target_key] = tgt[target_key] + d if target_key in tgt else d
    return unet_d, text_d
