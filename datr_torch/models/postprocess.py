"""PostProcess: model outputs -> scored boxes, and static-shape class-aware
NMS (port of datr_tpu/models/postprocess.py).

`batched_nms` makes datr_tpu's decisions: the same class offset (one span
over the whole batch), the same candidate order (a stable top-k, so ties
order as jax.lax.top_k does), the same f32 IoU and the same greedy rule.
datr_tpu walks the candidates in a 300-step scan on the device; here the
suppression matrix of every candidate pair is computed in one device pass,
copied to the host once, walked there in numpy, and the kept indices copied
back: a chain of dependent steps that would otherwise be hundreds of tiny
launches.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..utils.boxes import box_cxcywh_to_xyxy
from .dino import _stable_topk_indices


def postprocess(
    pred_logits: torch.Tensor,  # [B, N, K]
    pred_boxes: torch.Tensor,  # [B, N, 4] normalized cxcywh
    target_sizes: torch.Tensor,  # [B, 2] (h, w)
    num_select: int = 300,
    not_to_xyxy: bool = False,
) -> Dict[str, torch.Tensor]:
    """Flat top-k over (queries x classes), boxes (xyxy unless
    `not_to_xyxy`) scaled to target_sizes. Returns scores, labels, boxes
    and the producing query."""
    B, N, K = pred_logits.shape
    num_select = min(num_select, N * K)
    prob = pred_logits.sigmoid().reshape(B, N * K)
    topk = _stable_topk_indices(prob, num_select)
    scores = torch.gather(prob, 1, topk)
    topk_queries = topk // K
    labels = topk % K
    boxes = pred_boxes if not_to_xyxy else box_cxcywh_to_xyxy(pred_boxes)
    boxes = torch.gather(boxes, 1, topk_queries[..., None].expand(-1, -1, 4))
    h, w = target_sizes[:, 0], target_sizes[:, 1]
    scale = torch.stack([w, h, w, h], -1).to(boxes.dtype)
    return {"scores": scores, "labels": labels,
            "boxes": boxes * scale[:, None, :], "queries": topk_queries}


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, M] or [B, M, C] gathered at idx [B, k] along dim 1."""
    if x.dim() == 3:
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    return torch.gather(x, 1, idx)


def postprocess_with_nms(pred_logits, pred_boxes, target_sizes,
                         num_select: int = 300,
                         nms_iou_threshold: float = 0.7,
                         max_out: int = 100) -> Dict[str, torch.Tensor]:
    """PostProcess followed by class-aware NMS (reference dino.py:989-992):
    fixed-size results of `max_out` rows with a `valid` mask; the scores of
    rows that are not valid are -1."""
    res = postprocess(pred_logits, pred_boxes, target_sizes, num_select)
    keep_idx, keep_valid = batched_nms(res["boxes"], res["scores"],
                                       res["labels"], nms_iou_threshold,
                                       max_out)
    return {
        "scores": torch.where(keep_valid, take_rows(res["scores"], keep_idx),
                              -1.0),
        "labels": take_rows(res["labels"], keep_idx),
        "boxes": take_rows(res["boxes"], keep_idx),
        "queries": take_rows(res["queries"], keep_idx),
        "valid": keep_valid,
    }


def _greedy_keep(suppress: np.ndarray) -> np.ndarray:
    """suppress [B, M, M] (candidate i, once kept, removes j) -> kept [B, M]
    of the greedy walk in candidate order."""
    B, M, _ = suppress.shape
    kept = np.zeros((B, M), bool)
    for b in range(B):
        alive = np.ones(M, bool)
        for i in range(M):
            if alive[i]:
                kept[b, i] = True
                alive &= ~suppress[b, i]
    return kept


def batched_nms(
    boxes: torch.Tensor,  # [B, M, 4] xyxy
    scores: torch.Tensor,  # [B, M]
    labels: torch.Tensor,  # [B, M] int: NMS is applied per class
    iou_threshold: float = 0.7,
    max_out: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keep_idx [B, min(M, max_out)] int32, keep_valid bool): the kept
    candidates in descending score order, then the suppressed ones in
    candidate order, marked not valid. Every candidate takes part, whatever
    its score (callers mark the ones to drop with a score of -1, below every
    real one)."""
    B, M, _ = boxes.shape
    span = boxes.max() + 1.0  # over the whole batch
    obox = boxes + labels.to(boxes.dtype)[..., None] * span
    order = _stable_topk_indices(scores, M)
    x0, y0, x1, y1 = take_rows(obox, order).unbind(-1)
    area = (x1 - x0).clamp(min=0) * (y1 - y0).clamp(min=0)
    inter = ((torch.minimum(x1[:, :, None], x1[:, None, :])
              - torch.maximum(x0[:, :, None], x0[:, None, :])).clamp(min=0)
             * (torch.minimum(y1[:, :, None], y1[:, None, :])
                - torch.maximum(y0[:, :, None], y0[:, None, :])).clamp(min=0))
    iou = inter / (area[:, :, None] + area[:, None, :] - inter).clamp(min=1e-9)
    later = torch.ones(M, M, dtype=torch.bool, device=boxes.device).triu(1)
    kept = torch.from_numpy(_greedy_keep(
        ((iou > iou_threshold) & later).cpu().numpy())).to(boxes.device)
    rank = torch.where(kept, torch.arange(M, device=boxes.device), M + 1)
    sel = torch.sort(rank, dim=-1, stable=True).indices[:, :max_out]
    return (torch.gather(order, 1, sel).to(torch.int32),
            torch.gather(kept, 1, sel))
