"""Epoch loop of the burn-in stage (port of datr_tpu/engine.py:34-97).

`train_one_epoch` runs `train_step_burnin` over the batches, averages the
scalar metrics, and stops on a non-finite loss (reference engine.py:81-84).
The metrics stay on the device between drains: every DRAIN_EVERY steps one
copy brings them to the host, so the loop does not wait for the card each
step."""

from __future__ import annotations

import math
import sys
from typing import Dict, Iterable, List

import torch

from .train.criterion import CriterionCfg
from .train.state import TrainState
from .train.steps import train_step_burnin

DRAIN_EVERY = 10  # steps between host copies of the metrics

def _drain(pending: List[Dict[str, torch.Tensor]],
           sums: Dict[str, float], counts: Dict[str, int]):
    """One host copy of the pending metric dicts; exit on a non-finite
    loss."""
    if not pending:
        return
    keys = list(pending[0])
    host = torch.stack([torch.stack([m[k].float() for k in keys])
                        for m in pending]).cpu().tolist()
    for row in host:
        metrics = dict(zip(keys, row))
        if not math.isfinite(metrics["loss"]):
            print(f"Loss is {metrics['loss']}, stopping training",
                  file=sys.stderr)
            sys.exit(1)
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + v
            counts[k] = counts.get(k, 0) + 1
    pending.clear()


def train_one_epoch(state: TrainState, loader: Iterable,
                    ccfg: CriterionCfg,
                    weight_dict: Dict[str, float]) -> Dict[str, float]:
    """Burn-in epoch over `loader` (batches as `synthetic_da_batch` builds
    them, on the model's device). Returns the mean of every metric."""
    sums: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    pending: List[Dict[str, torch.Tensor]] = []
    for i, batch in enumerate(loader):
        pending.append(train_step_burnin(state, batch, ccfg, weight_dict))
        if i % DRAIN_EVERY == 0:
            _drain(pending, sums, counts)
    _drain(pending, sums, counts)
    return {k: sums[k] / counts[k] for k in sums}
