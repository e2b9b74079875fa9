"""Sigmoid focal loss and sigmoid cross-entropy (port of
datr_tpu/ops/focal.py:10-34)."""

from __future__ import annotations

import torch


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise sigmoid binary cross-entropy with
    logits (optax's sigmoid_binary_cross_entropy)."""
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Elementwise focal loss over {0, 1} float targets; the caller reduces
    and normalizes."""
    p = torch.sigmoid(logits)
    ce = sigmoid_ce(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * ((1.0 - p_t) ** gamma)
    if alpha >= 0:
        alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
        loss = alpha_t * loss
    return loss
