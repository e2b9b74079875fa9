"""Training state (port of datr_tpu/train/state.py): the model, its
optimizer, the three EMA tracks, the running class prototypes, the counters
and the generator of the CDN noise.

The EMA tracks are copies of the model in eval mode without gradients:
- ema_teacher: the pseudo-label teacher, ModelEMA(0.9997) per epoch
  (reference main.py:292);
- best_ema: the CosineEMA track of the teacher (main.py:382-386);
- model_ema: the per-step `--use_ema` track of the student
  (util/utils.py:373-397, main.py:149-152).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .optim import Optimizer

EMA_TRACKS = ("ema_teacher", "best_ema", "model_ema")


def frozen_copy(model: nn.Module) -> nn.Module:
    """A copy of `model` in eval mode whose parameters take no gradient."""
    ema = copy.deepcopy(model).eval()
    ema.requires_grad_(False)
    return ema


@dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    ema_teacher: nn.Module
    best_ema: nn.Module
    model_ema: nn.Module
    global_proto: torch.Tensor  # [K, C]
    amount: torch.Tensor  # [K]
    step: int
    ema_updates: int  # per-epoch teacher updates, for the ramped decay
    dn_generator: torch.Generator  # CPU generator of the CDN noise
    # the student as the training steps call it: its DistributedDataParallel
    # wrapper across ranks (parallel/mesh.py:shard_train_state), else None
    wrapped: Optional[nn.Module] = None


def create_train_state(model: nn.Module, optimizer: Optimizer,
                       seed: int = 0) -> TrainState:
    dev = next(model.parameters()).device
    return TrainState(
        model=model,
        optimizer=optimizer,
        **{name: frozen_copy(model) for name in EMA_TRACKS},
        global_proto=torch.zeros(model.num_classes, model.hidden_dim,
                                 device=dev),
        amount=torch.zeros(model.num_classes, device=dev),
        step=0,
        ema_updates=0,
        dn_generator=torch.Generator().manual_seed(seed),
    )
