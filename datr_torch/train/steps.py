"""Training and eval steps (port of datr_tpu/train/steps.py).

Burn-in: forward (paired DA batch) -> criterion -> weighted total ->
backward -> clip -> AdamW -> carry of the prototype state. Self-training
adds, in front, the EMA teacher's forward on the weak target half and its
pseudo-labels, and behind the source criterion, the target criterion on the
student's strong-view outputs. Batches are dicts of tensors on the model's
device:
  images   [B, H, W, 3]  first half source, second half target
  pad_mask [B, H, W]
  boxes    [B//2, T, 4] | labels [B//2, T] | valid [B//2, T]   (source GT)
  (self-training) images_strong [B, H, W, 3]: source weak, target strong
Single-domain training (`train_step_plain`) supervises the whole batch:
boxes / labels / valid are [B, T, ...] and there is no DA branch. A batch's
`masks` [B, T, h4, w4] (instance masks, single-domain) reach the criterion
as its mask targets.

Across ranks each rank runs the step on its share of the global batch: the
student is called through its DDP wrapper (`state.wrapped`) or is itself
sharded (FSDP), the criterion and the prototypes reduce their counts and
sums (train/criterion.py, models/da.py), the teacher labels the rank's own
target images, and the returned metrics are global: the mean over the
ranks, the sum for `num_pseudo` (the reference's reduce_dict).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models.cdn import CdnDraws
from ..models.postprocess import postprocess, postprocess_with_nms
from ..parallel.dist import reduce_metrics
from .criterion import CriterionCfg, criterion, weighted_total
from .ema import ema_update
from .pseudo import pseudo_labels_from_outputs
from .state import TrainState


def _student(state: TrainState):
    """The student as the step calls it: its DDP wrapper across ranks."""
    state.model.train()
    return state.model if state.wrapped is None else state.wrapped


def _student_forward(state: TrainState, images, batch, dn_draws,
                     self_training: bool = False, encoder_fn=None):
    model = _student(state)
    state.optimizer.zero_grad()
    return model(images, batch["pad_mask"],
                 targets={k: batch[k] for k in ("boxes", "labels", "valid")},
                 train=True, global_proto=state.global_proto,
                 amount=state.amount, dn_generator=state.dn_generator,
                 dn_draws=dn_draws, self_training=self_training,
                 encoder_fn=encoder_fn)


def loss_and_grads(state: TrainState, batch: Dict[str, torch.Tensor],
                   ccfg: CriterionCfg, weight_dict: Dict[str, float],
                   dn_draws: Optional[CdnDraws] = None, pp_mesh=None,
                   pp_n_micro: int = 0, pp_dp_axis: Optional[str] = None):
    """Burn-in forward, losses and backward; the gradients are left in
    `.grad`. With `pp_n_micro` the encoder is pipelined over `pp_mesh`'s
    'pipe' axis in that many microbatches (`pp_dp_axis`: the mesh's data
    axis). Returns (total, losses, outputs)."""
    encoder_fn = None
    if pp_n_micro:
        from ..parallel.pipeline import make_pp_encoder_fn

        encoder_fn = make_pp_encoder_fn(state.model, mesh=pp_mesh,
                                        n_micro=pp_n_micro,
                                        dp_axis=pp_dp_axis)
    out = _student_forward(state, batch["images"], batch, dn_draws,
                           encoder_fn=encoder_fn)
    losses = criterion(out, batch["labels"], batch["boxes"], batch["valid"],
                       ccfg, gt_masks=batch.get("masks"))
    total = weighted_total(losses, weight_dict)
    total.backward()
    return total, losses, out


def _update(state: TrainState, out, ema_decay: float) -> torch.Tensor:
    """Clip + AdamW, the prototype carry (when `out` has one), the step
    count and the per-step `model_ema` lerp (datr_tpu/train/steps.py:
    91-96). Returns the pre-clip gradient norm."""
    grad_norm = state.optimizer.step(state.step)
    state.optimizer.zero_grad()
    if "new_global_proto" in out:
        state.global_proto = out["new_global_proto"].detach()
        state.amount = out["new_amount"].detach()
    state.step += 1
    if ema_decay > 0.0:
        ema_update(state.model_ema, state.model, ema_decay)
    return grad_norm


def train_step_burnin(state: TrainState, batch: Dict[str, torch.Tensor],
                      ccfg: CriterionCfg, weight_dict: Dict[str, float],
                      ema_decay: float = 0.0,
                      dn_draws: Optional[CdnDraws] = None,
                      pp_mesh=None, pp_n_micro: int = 0,
                      pp_dp_axis: Optional[str] = None
                      ) -> Dict[str, torch.Tensor]:
    """One burn-in step; updates `state` in place. Returns the metrics as
    0-d tensors on the device: `loss`, every loss term and `grad_norm` (the
    pre-clip norm over the trainable parameters). `dn_draws` replaces the
    CDN noise drawn from the state's generator (tests feed datr_tpu's).
    `pp_mesh` / `pp_n_micro` / `pp_dp_axis`: the pipelined encoder
    (`loss_and_grads`)."""
    total, losses, out = loss_and_grads(state, batch, ccfg, weight_dict,
                                        dn_draws, pp_mesh, pp_n_micro,
                                        pp_dp_axis)
    grad_norm = _update(state, out, ema_decay)
    return reduce_metrics({"loss": total.detach(),
                           **{k: v.detach() for k, v in losses.items()},
                           "grad_norm": grad_norm.detach()})


def plain_loss_and_grads(state: TrainState, batch: Dict[str, torch.Tensor],
                         ccfg: CriterionCfg, weight_dict: Dict[str, float],
                         dn_draws: Optional[CdnDraws] = None):
    """The single-domain forward (the whole batch supervised, no DA
    branch), losses and backward; the gradients are left in `.grad`.
    Returns (total, losses, outputs)."""
    model = _student(state)
    state.optimizer.zero_grad()
    out = model(batch["images"], batch["pad_mask"],
                targets={k: batch[k] for k in ("boxes", "labels", "valid")},
                train=True, dn_generator=state.dn_generator,
                dn_draws=dn_draws, domain_adapt=False)
    losses = criterion(out, batch["labels"], batch["boxes"], batch["valid"],
                       ccfg, gt_masks=batch.get("masks"))
    total = weighted_total(losses, weight_dict)
    total.backward()
    return total, losses, out


def train_step_plain(state: TrainState, batch: Dict[str, torch.Tensor],
                     ccfg: CriterionCfg, weight_dict: Dict[str, float],
                     ema_decay: float = 0.0,
                     dn_draws: Optional[CdnDraws] = None
                     ) -> Dict[str, torch.Tensor]:
    """One single-domain supervised step, no DA branch (datr_tpu/train/
    steps.py:103-143); updates `state` in place and leaves the prototype
    state alone. Returns `loss`, every loss term and `grad_norm`."""
    total, losses, out = plain_loss_and_grads(state, batch, ccfg,
                                              weight_dict, dn_draws)
    grad_norm = _update(state, out, ema_decay)
    return reduce_metrics({"loss": total.detach(),
                           **{k: v.detach() for k, v in losses.items()},
                           "grad_norm": grad_norm.detach()})


@torch.no_grad()
def teacher_pseudo_labels(state: TrainState, batch: Dict[str, torch.Tensor],
                          class_thresholds: torch.Tensor,
                          canvas_hw: Tuple[int, int], num_select: int = 300,
                          max_pseudo: int = 100,
                          teacher: Optional[torch.nn.Module] = None):
    """The teacher's eval forward on the weak target half and its
    pseudo-labels (boxes, labels, valid, img_has_pseudo). The teacher is
    the EMA teacher, or `teacher`, an external model of any architecture
    with the student's classes (cross-architecture distillation,
    datr_tpu/train/steps.py:164-183). It draws no CDN noise and leaves the
    prototype state alone."""
    half = batch["images"].shape[0] // 2
    model = state.ema_teacher if teacher is None else teacher
    out = model(batch["images"][half:], batch["pad_mask"][half:])
    return pseudo_labels_from_outputs(out["pred_logits"], out["pred_boxes"],
                                      canvas_hw, class_thresholds,
                                      num_select=num_select,
                                      max_pseudo=max_pseudo)


def self_training_loss_and_grads(state: TrainState,
                                 batch: Dict[str, torch.Tensor],
                                 ccfg: CriterionCfg,
                                 weight_dict: Dict[str, float], pseudo,
                                 dn_draws: Optional[CdnDraws] = None):
    """The student's forward on the strong views, the source and the target
    criterion, backward; the gradients are left in `.grad`. Returns (total,
    source losses, target losses, outputs)."""
    p_boxes, p_labels, p_valid, img_has = pseudo
    out = _student_forward(state, batch["images_strong"], batch, dn_draws,
                           self_training=True)
    src = criterion(out, batch["labels"], batch["boxes"], batch["valid"],
                    ccfg)
    tgt = criterion(out, p_labels, p_boxes, p_valid, ccfg,
                    target_domain=True, img_mask=img_has.to(torch.float32))
    total = (weighted_total(src, weight_dict)
             + weight_dict.get("loss_self_training", 1.0)
             * weighted_total(tgt, weight_dict))
    total.backward()
    return total, src, tgt, out


def train_step_self_training(state: TrainState,
                             batch: Dict[str, torch.Tensor],
                             ccfg: CriterionCfg,
                             weight_dict: Dict[str, float],
                             class_thresholds: torch.Tensor,
                             canvas_hw: Tuple[int, int],
                             num_select: int = 300, max_pseudo: int = 100,
                             ema_decay: float = 0.0,
                             dn_draws: Optional[CdnDraws] = None,
                             teacher: Optional[torch.nn.Module] = None
                             ) -> Dict[str, torch.Tensor]:
    """One self-training step (datr_tpu/train/steps.py:146-231); updates
    `state` in place. `teacher` (an external model in eval mode) makes the
    pseudo-labels in place of the EMA teacher; it is never updated, and the
    EMA tracks go on as without it. Returns `loss`, `num_pseudo`,
    `grad_norm`, the source losses and the target losses as `{k}_target`,
    0-d tensors on the device."""
    pseudo = teacher_pseudo_labels(state, batch, class_thresholds, canvas_hw,
                                   num_select, max_pseudo, teacher)
    total, src, tgt, out = self_training_loss_and_grads(
        state, batch, ccfg, weight_dict, pseudo, dn_draws)
    grad_norm = _update(state, out, ema_decay)
    return reduce_metrics({
        "loss": total.detach(), "num_pseudo": pseudo[2].sum(),
        "grad_norm": grad_norm.detach(),
        **{k: v.detach() for k, v in src.items()},
        **{f"{k}_target": v.detach() for k, v in tgt.items()}})


@torch.no_grad()
def eval_step(model, batch: Dict[str, torch.Tensor], num_select: int = 300,
              nms_iou_threshold: float = -1.0,
              not_to_xyxy: bool = False,
              with_masks: bool = False) -> Dict[str, torch.Tensor]:
    """Forward + postprocess for evaluation (datr_tpu/train/steps.py:
    234-272): boxes scaled to `orig_sizes`. A positive `nms_iou_threshold`
    adds the class-aware NMS, and the result a `valid` mask; `not_to_xyxy`
    keeps the boxes cxcywh. `with_masks` adds each detection's stride-4
    mask logits, rounded to f16 and gathered by its query (`mask_logits`
    [B, num_select, h4, w4])."""
    out = model(batch["images"], batch["pad_mask"])
    if nms_iou_threshold > 0:
        res = postprocess_with_nms(out["pred_logits"], out["pred_boxes"],
                                   batch["orig_sizes"], num_select,
                                   nms_iou_threshold, max_out=num_select)
    else:
        res = postprocess(out["pred_logits"], out["pred_boxes"],
                          batch["orig_sizes"], num_select,
                          not_to_xyxy=not_to_xyxy)
    if with_masks:
        res["mask_logits"] = gather_masks(out["pred_masks"], res["queries"])
    return res


def gather_masks(pred_masks: torch.Tensor, queries: torch.Tensor
                 ) -> torch.Tensor:
    """pred_masks [B, Q, h, w] rounded to f16 (the device-to-host copy's
    size halved, as datr_tpu does) and gathered at queries [B, k]."""
    pm = pred_masks.to(torch.float16)
    B, k = queries.shape
    idx = queries.long()[:, :, None, None].expand(B, k, *pm.shape[-2:])
    return torch.gather(pm, 1, idx)
