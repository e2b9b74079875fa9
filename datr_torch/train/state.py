"""Training state (port of datr_tpu/train/state.py for the burn-in stage):
the model, its optimizer, the running class prototypes, the step count and
the generator of the CDN noise. The EMA copies come with self-training."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .optim import Optimizer


@dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    global_proto: torch.Tensor  # [K, C]
    amount: torch.Tensor  # [K]
    step: int
    dn_generator: torch.Generator  # CPU generator of the CDN noise


def create_train_state(model: nn.Module, optimizer: Optimizer,
                       seed: int = 0) -> TrainState:
    dev = next(model.parameters()).device
    return TrainState(
        model=model,
        optimizer=optimizer,
        global_proto=torch.zeros(model.num_classes, model.hidden_dim,
                                 device=dev),
        amount=torch.zeros(model.num_classes, device=dev),
        step=0,
        dn_generator=torch.Generator().manual_seed(seed),
    )
