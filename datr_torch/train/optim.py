"""Parameter groups, AdamW, gradient clipping and the learning-rate schedules
(port of datr_tpu/train/optim.py:20-132).

Groups, by the flax path datr_tpu labels (`_label_for_path`):
- frozen:   the backbone stem (`conv1`, `bn1`), `layer1_*` and every frozen
            batch-norm -> requires_grad=False (the norms are buffers here);
- backbone: the rest of the backbone -> lr_backbone;
- main:     everything else -> lr.
Both trainable groups use AdamW with the config's weight decay. The gradient
is clipped to a global norm over the trainable parameters only, as optax's
clip_by_global_norm does after datr_tpu zeroes the frozen group. The norm
is the whole model's: under FSDP (`fully_shard`) each rank holds a shard of
every gradient and the shards' squares are summed over the data axis;
under tensor parallelism (a model split by parallel/mesh.py `apply_tp`)
each split tensor's squares count once per shard, summed over 'model', and
each whole (replicated) tensor's once.

The ranks of a model axis ('model', 'seq', 'pipe') compute the gradient
of every tensor they hold whole alike, but not bitwise on the card: the
atomic adds of a backward (a gather's, MSDA's) sum in another order on
each rank. Before the clip, those gradients are averaged over the axis in
one all-reduce, so the ranks' copies of the model stay bitwise equal (a
mean of equal values is exact: on the CPU nothing changes).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..parallel import dist as pdist


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a sharded (DTensor) tensor, else `t`."""
    return t.to_local() if hasattr(t, "to_local") else t


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


def piecewise_constant(base: float, step: int,
                       boundaries_and_scales: Dict[int, float]) -> float:
    """optax.piecewise_constant_schedule: `base` times every scale whose
    boundary `step` has reached."""
    v = base
    for boundary, scale in sorted(boundaries_and_scales.items()):
        if step >= boundary:
            v *= scale
    return v


def cosine_onecycle(peak: float, step: int, total_steps: int,
                    pct_start: float = 0.3, div_factor: float = 25.0,
                    final_div_factor: float = 1e4) -> float:
    """optax.cosine_onecycle_schedule: from peak / div_factor up to `peak`
    over the first pct_start of `total_steps`, then down to
    peak / div_factor / final_div_factor, each leg a half cosine."""
    bounds = [0, int(pct_start * total_steps), int(total_steps)]
    values = [peak / div_factor]
    values += [values[-1] * div_factor,
               values[-1] * div_factor / (div_factor * final_div_factor)]
    for i in range(2):
        if bounds[i] <= step < bounds[i + 1]:
            pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
            start, end = values[i], values[i + 1]
            return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
    return values[-1]


class Optimizer:
    """AdamW over the main and backbone groups, with global-norm clipping and
    datr_tpu's schedules (make_optimizer, datr_tpu/train/optim.py:83-96),
    each group's from its own base lr, in this order of precedence:
    - 'onecycle' with `total_steps`: optax.cosine_onecycle_schedule;
    - 'multistep' with `lr_drop_steps`: times lr_drop_factor at each;
    - `lr_drop_step`: times lr_drop_factor from that update on;
    - else constant."""

    def __init__(self, model: nn.Module, lr: float = 1e-4,
                 lr_backbone: float = 1e-5, weight_decay: float = 1e-4,
                 clip_max_norm: float = 0.1, lr_drop_factor: float = 0.1,
                 lr_drop_step: Optional[int] = None,
                 schedule_type: str = "step",
                 lr_drop_steps: Optional[Sequence[int]] = None,
                 total_steps: Optional[int] = None):
        if schedule_type not in ("step", "multistep", "onecycle"):
            raise ValueError(f"unknown schedule_type {schedule_type!r}")
        self.base_lr = {"main": lr, "backbone": lr_backbone}
        self.weight_decay = weight_decay
        self.clip_max_norm = clip_max_norm
        self.lr_drop_factor = lr_drop_factor
        self.lr_drop_step = lr_drop_step
        self.schedule_type = schedule_type
        self.lr_drop_steps = list(lr_drop_steps or [])
        self.total_steps = total_steps
        self._build(model)

    def _build(self, model: nn.Module):
        groups = freeze_and_group(model)
        self.params = groups["main"] + groups["backbone"]
        # optax.adamw defaults: b1 0.9, b2 0.999, eps 1e-8, decoupled decay
        self.opt = torch.optim.AdamW(
            [{"params": groups[g], "lr": self.base_lr[g], "name": g}
             for g in ("main", "backbone")],
            betas=(0.9, 0.999), eps=1e-8, weight_decay=self.weight_decay)
        self._sharded = any(hasattr(p, "to_local") for p in self.params)
        # the tensor-parallel split of each parameter (apply_tp's plan)
        plan = getattr(model, "tp_plan", {})
        tp = getattr(model, "tp", None)
        self.tp_axis = getattr(tp, "axis", None) if plan else None
        names = {id(p): n for n, p in model.named_parameters()}
        self.names = [names[id(p)] for p in self.params]
        self.tp_split = [n in plan for n in self.names]

    def rebind(self, model: nn.Module):
        """Rebuild over `model`'s parameters as they are now (after
        `fully_shard` replaced them by sharded ones), parameter for
        parameter in the same order; moments already taken are carried over,
        laid out as their new parameter."""
        old_params, old_state = self.params, self.opt.state
        self._build(model)
        if len(old_params) != len(self.params):
            raise ValueError("rebind: the model's parameters changed")
        for old, new in zip(old_params, self.params):
            if old not in old_state:
                continue
            st = {}
            for k, v in old_state[old].items():
                if (torch.is_tensor(v) and hasattr(new, "device_mesh")
                        and v.shape == new.shape):
                    from torch.distributed.tensor import distribute_tensor

                    v = distribute_tensor(v.to(new.device),
                                          new.device_mesh, new.placements)
                st[k] = v
            self.opt.state[new] = st

    def lr_at(self, step: int, group: str = "main") -> float:
        """The group's learning rate for update number `step` (0-based)."""
        base = self.base_lr[group]
        if self.schedule_type == "onecycle" and self.total_steps:
            return cosine_onecycle(base, step, self.total_steps)
        if self.schedule_type == "multistep" and self.lr_drop_steps:
            return piecewise_constant(
                base, step, {s: self.lr_drop_factor
                             for s in self.lr_drop_steps})
        if self.lr_drop_step is not None:
            return piecewise_constant(base, step,
                                      {self.lr_drop_step: self.lr_drop_factor})
        return base

    def grad_norm(self) -> torch.Tensor:
        """Global norm of the trainable gradients (missing ones count 0);
        over every rank's shard when the parameters are sharded."""
        grads = [_local(p.grad) for p in self.params if p.grad is not None]
        if not self._sharded and self.tp_axis is None:
            return torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        # each shard's norm, squared and summed in f64: [split ; whole]
        split = [s for p, s in zip(self.params, self.tp_split)
                 if p.grad is not None]
        sq = torch.stack([torch.linalg.vector_norm(g) for g in grads]
                         ).double().pow(2)
        mask = torch.tensor(split, device=sq.device)
        sq = torch.stack([sq[mask].sum(), sq[~mask].sum()])
        if self._sharded:
            sq = pdist.all_reduce_sum(sq)
        if self.tp_axis is not None:
            sq[0] = pdist.all_reduce_sum(sq[0], self.tp_axis)
        return sq.sum().sqrt().to(torch.float32)

    def _average_over_model_axes(self):
        """Each model axis's whole tensors' gradients averaged over it
        (the module docstring): on 'model' those the plan leaves whole, on
        'seq' and 'pipe' all (whose ranks hold every tensor whole)."""
        for axis in ("model", "seq", "pipe"):
            n = pdist.process_count(axis)
            if n == 1:
                continue
            grads = [_local(p.grad) for p, split in
                     zip(self.params, self.tp_split)
                     if not (split and axis == self.tp_axis)]
            flat = torch.cat([g.reshape(-1) for g in grads])
            flat = pdist.all_reduce_sum(flat, axis) / n
            torch._foreach_copy_(grads, [
                f.view_as(g) for f, g in zip(
                    flat.split([g.numel() for g in grads]), grads)])

    def step(self, step: int) -> torch.Tensor:
        """Clip, then one AdamW update at the schedule's lr for update
        number `step` (0-based). Returns the pre-clip gradient norm."""
        for p in self.params:  # optax updates every leaf, grad or not
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._average_over_model_axes()
        norm = self.grad_norm()
        if self.clip_max_norm > 0:
            # optax: g if norm < max else g / norm * max
            scale = torch.where(norm < self.clip_max_norm,
                                torch.ones_like(norm),
                                self.clip_max_norm / norm)
            torch._foreach_mul_([_local(p.grad) for p in self.params],
                                scale)
        for group in self.opt.param_groups:
            group["lr"] = self.lr_at(step, group["name"])
        self.opt.step()
        return norm

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)
