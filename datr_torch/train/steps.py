"""The burn-in training step (port of datr_tpu/train/steps.py:36-97).

forward (paired DA batch) -> criterion -> weighted total -> backward ->
clip -> AdamW -> carry of the prototype state. Batches are dicts of tensors
on the model's device:
  images   [B, H, W, 3]  first half source, second half target
  pad_mask [B, H, W]
  boxes    [B//2, T, 4] | labels [B//2, T] | valid [B//2, T]   (source GT)
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.cdn import CdnDraws
from .criterion import CriterionCfg, criterion, weighted_total
from .state import TrainState


def loss_and_grads(state: TrainState, batch: Dict[str, torch.Tensor],
                   ccfg: CriterionCfg, weight_dict: Dict[str, float],
                   dn_draws: Optional[CdnDraws] = None):
    """Forward, losses and backward; the gradients are left in `.grad`.
    Returns (total, losses, outputs)."""
    model = state.model
    model.train()
    state.optimizer.zero_grad()
    out = model(batch["images"], batch["pad_mask"],
                targets={k: batch[k] for k in ("boxes", "labels", "valid")},
                train=True, global_proto=state.global_proto,
                amount=state.amount, dn_generator=state.dn_generator,
                dn_draws=dn_draws)
    losses = criterion(out, batch["labels"], batch["boxes"], batch["valid"],
                       ccfg)
    total = weighted_total(losses, weight_dict)
    total.backward()
    return total, losses, out


def train_step_burnin(state: TrainState, batch: Dict[str, torch.Tensor],
                      ccfg: CriterionCfg, weight_dict: Dict[str, float],
                      ema_decay: float = 0.0,
                      dn_draws: Optional[CdnDraws] = None
                      ) -> Dict[str, torch.Tensor]:
    """One burn-in step; updates `state` in place. Returns the metrics as
    0-d tensors on the device: `loss`, every loss term and `grad_norm` (the
    pre-clip norm over the trainable parameters). `dn_draws` replaces the
    CDN noise drawn from the state's generator (tests feed datr_tpu's)."""
    if ema_decay != 0.0:
        raise NotImplementedError("the EMA copies come with self-training")
    total, losses, out = loss_and_grads(state, batch, ccfg, weight_dict,
                                        dn_draws)
    grad_norm = state.optimizer.step(state.step)
    state.optimizer.zero_grad()
    state.global_proto = out["new_global_proto"].detach()
    state.amount = out["new_amount"].detach()
    state.step += 1
    return {"loss": total.detach(),
            **{k: v.detach() for k, v in losses.items()},
            "grad_norm": grad_norm.detach()}
