"""Python-file configs with `_base_` inheritance and `key=value` overrides.

The port's own copy of datr_tpu/config.py (same semantics, so it reads the
repo's `configs/` unchanged): configs are plain Python files of module-level
variables, `_base_` lists files to inherit from, `_delete_: True` in a nested
dict replaces instead of merging.
"""

from __future__ import annotations

import ast
import copy
import importlib.util
import os
import sys
from typing import Any, Dict, List


class Config(dict):
    """dict with attribute access; nested dicts are wrapped on the fly."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        if isinstance(v, dict) and not isinstance(v, Config):
            v = Config(v)
            self[k] = v
        return v

    def __setattr__(self, k, v):
        self[k] = v


_DELETE = "_delete_"
_BASE = "_base_"


def _exec_py_config(path: str) -> Dict[str, Any]:
    path = os.path.abspath(path)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    name = f"_datr_torch_cfg_{abs(hash(path))}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
        cfg = {
            k: copy.deepcopy(v)
            for k, v in vars(mod).items()
            if not k.startswith("__") and not callable(v)
            and not isinstance(v, type(sys))
        }
    finally:
        sys.modules.pop(name, None)
    return cfg


def deep_merge(base: Dict, override: Dict) -> Dict:
    """Merge override into base (override wins)."""
    out = dict(base)
    for k, v in override.items():
        if (isinstance(v, dict) and k in out and isinstance(out[k], dict)
                and not v.get(_DELETE, False)):
            out[k] = deep_merge(out[k], v)
        else:
            if isinstance(v, dict):
                v = {kk: vv for kk, vv in v.items() if kk != _DELETE}
            out[k] = v
    return out


def load_config(path: str) -> Config:
    cfg = _exec_py_config(path)
    bases = cfg.pop(_BASE, [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for b in bases:
        bpath = os.path.join(os.path.dirname(os.path.abspath(path)), b)
        merged = deep_merge(merged, dict(load_config(bpath)))
    return Config(deep_merge(merged, cfg))


def parse_override(kv: str) -> Dict[str, Any]:
    """'a.b=1' -> {'a': {'b': 1}}, the value literal-evaluated."""
    if "=" not in kv:
        raise ValueError(f"override must be key=value, got {kv!r}")
    key, raw = kv.split("=", 1)
    try:
        val = ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        low = raw.lower()
        if low in ("true", "false"):
            val = low == "true"
        elif low in ("none", "null"):
            val = None
        else:
            val = raw
    node: Dict[str, Any] = {}
    cur = node
    parts = key.strip().split(".")
    for p in parts[:-1]:
        cur[p] = {}
        cur = cur[p]
    cur[parts[-1]] = val
    return node


def apply_overrides(cfg: Config, options: List[str]) -> Config:
    out = dict(cfg)
    for kv in options or []:
        out = deep_merge(out, parse_override(kv))
    return Config(out)
