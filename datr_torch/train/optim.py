"""Parameter groups, AdamW, gradient clipping and the learning-rate schedule
(port of datr_tpu/train/optim.py:20-132).

Groups, by the flax path datr_tpu labels (`_label_for_path`):
- frozen:   the backbone stem (`conv1`, `bn1`), `layer1_*` and every frozen
            batch-norm -> requires_grad=False (the norms are buffers here);
- backbone: the rest of the backbone -> lr_backbone;
- main:     everything else -> lr.
Both trainable groups use AdamW with the config's weight decay. The gradient
is clipped to a global norm over the trainable parameters only, as optax's
clip_by_global_norm does after datr_tpu zeroes the frozen group.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn


def param_group(name: str) -> str:
    """'frozen', 'backbone' or 'main' for a parameter or buffer name of the
    port's DINO (`backbone.layer2_block0.conv1.weight`, ...)."""
    keys = name.split(".")
    if keys[0] != "backbone":
        return "main"
    sub = keys[1] if len(keys) > 1 else ""
    if sub in ("conv1", "bn1") or sub.startswith("layer1_"):
        return "frozen"
    if len(keys) >= 2 and keys[-2].startswith(("bn", "downsample_bn")):
        return "frozen"
    return "backbone"


def freeze_and_group(model: nn.Module) -> Dict[str, List[nn.Parameter]]:
    """Sets requires_grad=False on the frozen group and returns the
    parameters of each group."""
    groups: Dict[str, List[nn.Parameter]] = {
        "main": [], "backbone": [], "frozen": []}
    for name, p in model.named_parameters():
        g = param_group(name)
        p.requires_grad_(g != "frozen")
        groups[g].append(p)
    return groups


class Optimizer:
    """AdamW over the main and backbone groups, with global-norm clipping and
    a step schedule: lr until `lr_drop_step` updates have been made, then
    lr * lr_drop_factor (optax.piecewise_constant_schedule)."""

    def __init__(self, model: nn.Module, lr: float = 1e-4,
                 lr_backbone: float = 1e-5, weight_decay: float = 1e-4,
                 clip_max_norm: float = 0.1, lr_drop_factor: float = 0.1,
                 lr_drop_step: Optional[int] = None):
        groups = freeze_and_group(model)
        self.base_lr = {"main": lr, "backbone": lr_backbone}
        self.clip_max_norm = clip_max_norm
        self.lr_drop_factor = lr_drop_factor
        self.lr_drop_step = lr_drop_step
        self.params = groups["main"] + groups["backbone"]
        # optax.adamw defaults: b1 0.9, b2 0.999, eps 1e-8, decoupled decay
        self.opt = torch.optim.AdamW(
            [{"params": groups[g], "lr": self.base_lr[g], "name": g}
             for g in ("main", "backbone")],
            betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)

    def lr_scale(self, step: int) -> float:
        if self.lr_drop_step is not None and step >= self.lr_drop_step:
            return self.lr_drop_factor
        return 1.0

    def grad_norm(self) -> torch.Tensor:
        """Global norm of the trainable gradients (missing ones count 0)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        return torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))

    def step(self, step: int) -> torch.Tensor:
        """Clip, then one AdamW update at the schedule's lr for update
        number `step` (0-based). Returns the pre-clip gradient norm."""
        for p in self.params:  # optax updates every leaf, grad or not
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = self.grad_norm()
        if self.clip_max_norm > 0:
            # optax: g if norm < max else g / norm * max
            scale = torch.where(norm < self.clip_max_norm,
                                torch.ones_like(norm),
                                self.clip_max_norm / norm)
            torch._foreach_mul_([p.grad for p in self.params], scale)
        for group in self.opt.param_groups:
            group["lr"] = self.base_lr[group["name"]] * self.lr_scale(step)
        self.opt.step()
        return norm

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)
