"""YAML config system with single-level ``base:`` inheritance.

The port's own copy of ``live2diff_tpu/config.py`` (no JAX in it; the port
imports nothing of the JAX package).

Mirrors the behaviour of the reference's OmegaConf loader
(upstream Live2Diff live2diff/utils/config.py:10-17): a style config may name a
``base:`` YAML whose keys are recursively merged underneath the style
config's own keys. We use plain PyYAML plus an attribute-access dict so the
rest of the framework can write ``cfg.unet_additional_kwargs.motion_module_kwargs``.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Mapping

import yaml


class ConfigDict(dict):
    """A dict with attribute access, recursively applied."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get(self, key, default=None):
        return super().get(key, default)

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, Mapping):
            return ConfigDict({k: ConfigDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return [ConfigDict.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> dict:
        def unwrap(o):
            if isinstance(o, Mapping):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)


def _deep_merge(base: dict, override: dict) -> dict:
    """Merge ``override`` on top of ``base``, recursing into nested dicts."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(path: str) -> ConfigDict:
    """Load a YAML config, merging a one-level ``base:`` config if present.

    Relative ``base:`` paths are resolved against the config file's own
    directory first, then against the current working directory (the
    reference uses cwd-relative paths like ``./configs/base_config.yaml``).
    """
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}

    base_path = cfg.pop("base", None)
    if base_path is not None:
        candidates = [
            os.path.join(os.path.dirname(os.path.abspath(path)), base_path),
            base_path,
        ]
        for cand in candidates:
            if os.path.isfile(cand):
                base_path = cand
                break
        with open(base_path) as f:
            base_cfg = yaml.safe_load(f) or {}
        base_cfg.pop("base", None)
        cfg = _deep_merge(base_cfg, cfg)

    return ConfigDict.wrap(cfg)
