"""The system under test, `datr_torch`, as the cells drive it: its model
built from the repository's config through its registry, with the
benchmark's weights; its training state as its CLI builds one; its
inference server as its `serve` CLI builds one. This is the one module of
the harness that imports the measured package.
"""

from __future__ import annotations

from typing import Dict
from unittest import mock

import torch

from .spec import ROOT


def program_config(config: dict, overrides: dict = None):
    """The measured package's own config object for `config`: the
    repository's config file with the configuration's options."""
    from datr_torch.config import load_config

    cfg = load_config(str(ROOT / config["repo_config"]))
    cfg.update(config.get("options", {}))
    cfg.update(overrides or {})
    return cfg


def tiny_options(config: dict) -> dict:
    """The measured package's options for a configuration's `tiny` sizes
    (the CPU tests'): every model key that `tiny.model` changes, under the
    same name, and the canvas as `canvas_h` / `canvas_w`."""
    tiny = config["tiny"]
    opts = {k: v for k, v in tiny["model"].items()
            if config["model"].get(k) != v}
    opts.update(canvas_h=tiny["canvas"][0], canvas_w=tiny["canvas"][1])
    return opts


def build_model(config: dict, state_dict: Dict[str, torch.Tensor], device,
                overrides: dict = None):
    """(model, criterion cfg, weight dict, config) with `state_dict` loaded:
    the registry's model, its parameters allocated on `device` and never
    initialised by the package's own seeded init (the benchmark's weights
    replace it). Raises if the architecture differs from the weights'."""
    from datr_torch.models import build_model as registry_build
    from datr_torch.models.dino import DINO

    cfg = program_config(config, overrides)
    with mock.patch.object(DINO, "init_params", lambda self, gen: self), \
            torch.device(device):
        model, ccfg, wd = registry_build(cfg, device, seed=0)
    own = model.state_dict()
    bad = sorted(set(own) ^ set(state_dict)) or [
        k for k in own if own[k].shape != state_dict[k].shape]
    if bad:
        raise ValueError(f"the program's model differs from the "
                         f"configuration's at {bad[:8]}")
    model.load_state_dict(state_dict)
    return model, ccfg, wd, cfg


def train_state(model, cfg, seed: int, steps_per_epoch: int):
    """The CLI's optimizer and training state (datr_torch/main.py): AdamW
    with the config's learning rates, decay, clip and lr drop; the CDN
    noise generator seeded with `seed`."""
    from datr_torch.train.optim import Optimizer
    from datr_torch.train.state import create_train_state

    opt = Optimizer(model, lr=cfg.lr, lr_backbone=cfg.lr_backbone,
                    weight_decay=cfg.weight_decay,
                    clip_max_norm=cfg.clip_max_norm,
                    lr_drop_step=cfg.lr_drop * steps_per_epoch)
    return create_train_state(model, opt, seed=seed)


def train_one_epoch(state, loader, ccfg, wd):
    from datr_torch import engine

    return engine.train_one_epoch(state, loader, ccfg, wd)


def inference_server(model, canvas_hw, options: dict, device):
    """`datr_torch.serve.InferenceServer` with `serve.main`'s defaults
    (batch 2, two batches in flight, two dispatchers and collectors, a
    20 ms batch timeout, the u8 wire), and the cell's `options` over
    them."""
    from datr_torch.serve import InferenceServer

    kw = dict(batch_size=2, num_select=300, score_threshold=0.2,
              batch_timeout_s=0.02, max_in_flight=2, collector_threads=2,
              dispatcher_threads=2, wire_format="u8")
    kw.update(options)
    return InferenceServer(model, canvas_hw=tuple(canvas_hw), device=device,
                           **kw)
