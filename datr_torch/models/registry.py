"""Model registry (port of datr_tpu/models/registry.py): a model name ->
its build function. `build_model(cfg)` dispatches on the config's
`modelname` (default "dino"); the port's entries return
`(model, criterion cfg, weight_dict)`."""

from __future__ import annotations

from typing import Callable, Dict

MODEL_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn):
        if name in MODEL_REGISTRY:
            raise KeyError(f"model {name!r} already registered")
        MODEL_REGISTRY[name] = fn
        return fn

    return deco


def build_model(cfg, device=None, seed: int = 0):
    """The config's model with seeded weights on `device` (default: the
    CUDA card), in eval mode, with its `(CriterionCfg, weight_dict)`.
    Raises KeyError, listing the registered names, on an unknown
    `modelname`."""
    name = cfg.get("modelname", "dino") if hasattr(cfg, "get") else getattr(
        cfg, "modelname", "dino")
    if name not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](cfg, device=device, seed=seed)
