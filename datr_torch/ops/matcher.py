"""Bipartite matching of predictions to targets (port of
datr_tpu/ops/matcher.py:130-194).

The matching costs are computed on the device; the assignment is solved on
the host by scipy's `linear_sum_assignment` over the valid target rows only.
datr_tpu solves it in-graph (`hungarian`, a Jonker-Volgenant solver written
for the TPU); that solver is not ported, and the tests hold scipy's
assignments equal to its. `match_many` computes the costs of every decoder
layer and the encoder output of a step in one batched pass and copies them to
the host in one transfer.

Orientation: rows = targets (T), cols = predictions (N), T <= N. Invalid
(padded) target rows have zero cost and get assignment 0; callers mask them.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from ..utils.boxes import box_cxcywh_to_xyxy, generalized_box_iou


def detr_matching_cost(
    logits: torch.Tensor,  # [..., N, K]
    pred_boxes: torch.Tensor,  # [..., N, 4] cxcywh
    gt_labels: torch.Tensor,  # [..., T] int
    gt_boxes: torch.Tensor,  # [..., T, 4] cxcywh
    gt_valid: torch.Tensor,  # [..., T] bool
    cost_class: float = 2.0,
    cost_bbox: float = 5.0,
    cost_giou: float = 2.0,
    focal_alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """[..., T, N] focal-class + L1 + GIoU cost, invalid target rows zero.
    The targets broadcast against the predictions' leading dims."""
    prob = torch.sigmoid(logits)
    pos = focal_alpha * ((1.0 - prob) ** gamma) * (-torch.log(prob + 1e-8))
    neg = (1.0 - focal_alpha) * (prob ** gamma) * (
        -torch.log(1.0 - prob + 1e-8))
    labels = gt_labels.long()[..., None, :].expand(
        *logits.shape[:-1], gt_labels.shape[-1])
    cls = torch.gather(pos - neg, -1, labels)  # [..., N, T]
    l1 = (pred_boxes[..., :, None, :] - gt_boxes[..., None, :, :]).abs().sum(-1)
    giou = -generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes),
                                box_cxcywh_to_xyxy(gt_boxes))
    cost = cost_bbox * l1 + cost_class * cls + cost_giou * giou
    cost = torch.where(gt_valid[..., None, :], cost, 0.0)
    return cost.transpose(-1, -2)


def minsum_match(cost: torch.Tensor) -> torch.Tensor:
    """SimpleMinsumMatcher: each target takes its argmin-cost prediction
    independently (not necessarily injective). [..., T, N] -> [..., T]."""
    return cost.argmin(-1)


def solve_assignments(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Min-cost assignment of each valid target row: cost [..., T, N] and
    valid [..., T] on the host -> int64 [..., T] prediction per target (0 on
    invalid rows). Non-finite costs (a diverged step) become large finite
    ones, so the step still ends and its non-finite loss can stop training,
    as datr_tpu's in-graph solver lets it."""
    lead = cost.shape[:-2]
    flat_cost = np.nan_to_num(cost.reshape(-1, *cost.shape[-2:]), nan=1e9,
                              posinf=1e9, neginf=-1e9)
    flat_valid = np.broadcast_to(valid, (*lead, valid.shape[-1])).reshape(
        -1, valid.shape[-1])
    out = np.zeros(flat_valid.shape, np.int64)
    for i, (c, v) in enumerate(zip(flat_cost, flat_valid)):
        rows = np.flatnonzero(v)
        if rows.size:
            r, cols = linear_sum_assignment(c[rows])
            out[i, rows[r]] = cols
    return out.reshape(*lead, valid.shape[-1])


def match_many(
    preds: Sequence[Tuple[torch.Tensor, torch.Tensor]],  # [(logits, boxes)]
    gt_labels: torch.Tensor,  # [B, T]
    gt_boxes: torch.Tensor,  # [B, T, 4]
    gt_valid: torch.Tensor,  # [B, T]
    cost_class: float = 2.0,
    cost_bbox: float = 5.0,
    cost_giou: float = 2.0,
    focal_alpha: float = 0.25,
) -> List[torch.Tensor]:
    """Hungarian assignments [B, T] (int64, on the predictions' device) for
    several prediction sets of the same shape [B, N, K] / [B, N, 4]: one
    batched cost pass on the device, one copy to the host (the costs with
    the valid mask as one more column), scipy per (set, image) over the
    valid rows, one copy back."""
    logits = torch.stack([lg.detach() for lg, _ in preds]).float()
    boxes = torch.stack([bx.detach() for _, bx in preds]).float()
    cost = detr_matching_cost(logits, boxes, gt_labels, gt_boxes, gt_valid,
                              cost_class, cost_bbox, cost_giou, focal_alpha)
    valid = gt_valid.to(cost.dtype)[..., None].expand(*cost.shape[:-1], 1)
    host = torch.cat([cost, valid], -1).cpu().numpy()
    assign = solve_assignments(host[..., :-1], host[..., -1] != 0)
    return list(torch.from_numpy(assign).to(logits.device).unbind(0))


def batch_match(logits, pred_boxes, gt_labels, gt_boxes, gt_valid,
                cost_class: float = 2.0, cost_bbox: float = 5.0,
                cost_giou: float = 2.0,
                focal_alpha: float = 0.25) -> torch.Tensor:
    """Hungarian assignment [B, T] of one prediction set."""
    return match_many([(logits, pred_boxes)], gt_labels, gt_boxes, gt_valid,
                      cost_class, cost_bbox, cost_giou, focal_alpha)[0]
