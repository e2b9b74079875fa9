"""Pseudo-labels for self-training (port of datr_tpu/train/pseudo.py).

The EMA teacher's outputs on the weak target view -> top-k postprocess at
size (1, 1) -> per-class score threshold -> class-aware NMS(0.7) in canvas
pixels -> at most `max_pseudo` boxes per image, as fixed-size tensors with
a validity mask.

Kept boxes pass through in the teacher's own normalization. The reference
multiplies by the padded canvas before NMS and divides by the real image
size after (self_training_utils.py:68-90); on its constant-size datasets
canvas == real and the round trip is the identity, while on a static canvas
with images of several sizes it would inflate every pseudo box by
canvas / real. So NMS decides in canvas pixels, as the reference's does,
and the coordinates are the teacher's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.postprocess import batched_nms, postprocess, take_rows
from ..utils.boxes import box_cxcywh_to_xyxy


def pseudo_labels_from_outputs(
    pred_logits: torch.Tensor,  # [Bt, N, K] teacher outputs, target half
    pred_boxes: torch.Tensor,  # [Bt, N, 4] normalized cxcywh
    canvas_hw: Tuple[int, int],  # (H, W) of the padded canvas
    class_thresholds: torch.Tensor,  # [K] per-class score thresholds
    num_select: int = 300,
    max_pseudo: int = 100,
    nms_iou: float = 0.7,
):
    """Returns (boxes [Bt, max_pseudo, 4] normalized cxcywh, labels
    [Bt, max_pseudo], valid [Bt, max_pseudo], img_has_pseudo [Bt])."""
    Bt = pred_logits.shape[0]
    res = postprocess(pred_logits, pred_boxes,
                      torch.ones(Bt, 2, device=pred_logits.device),
                      num_select=num_select, not_to_xyxy=True)
    scores, labels, boxes = res["scores"], res["labels"], res["boxes"]
    valid = scores >= class_thresholds.to(scores.device)[labels]
    H, W = canvas_hw
    xyxy = box_cxcywh_to_xyxy(boxes) * torch.tensor(
        [W, H, W, H], dtype=torch.float32, device=boxes.device)
    # below-threshold candidates take part in NMS with score -1
    nms_scores = torch.where(valid, scores, -1.0)
    keep_idx, keep_valid = batched_nms(xyxy, nms_scores, labels,
                                       iou_threshold=nms_iou,
                                       max_out=max_pseudo)
    keep_idx = keep_idx.long()
    kept_valid = keep_valid & (take_rows(nms_scores, keep_idx) > 0)
    return (take_rows(boxes, keep_idx), take_rows(labels, keep_idx),
            kept_valid, kept_valid.any(1))
