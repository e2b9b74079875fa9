"""PostProcess: model outputs -> scored boxes (port of
datr_tpu/models/postprocess.py:20-54). NMS is off in every config
(`nms_iou_threshold = -1`) and not ported yet."""

from __future__ import annotations

from typing import Dict

import torch

from ..utils.boxes import box_cxcywh_to_xyxy
from .dino import _stable_topk_indices


def postprocess(
    pred_logits: torch.Tensor,  # [B, N, K]
    pred_boxes: torch.Tensor,  # [B, N, 4] normalized cxcywh
    target_sizes: torch.Tensor,  # [B, 2] (h, w)
    num_select: int = 300,
) -> Dict[str, torch.Tensor]:
    """Flat top-k over (queries x classes), xyxy boxes scaled to
    target_sizes. Returns scores, labels, boxes and the producing query."""
    B, N, K = pred_logits.shape
    num_select = min(num_select, N * K)
    prob = pred_logits.sigmoid().reshape(B, N * K)
    topk = _stable_topk_indices(prob, num_select)
    scores = torch.gather(prob, 1, topk)
    topk_queries = topk // K
    labels = topk % K
    boxes = box_cxcywh_to_xyxy(pred_boxes)
    boxes = torch.gather(boxes, 1, topk_queries[..., None].expand(-1, -1, 4))
    h, w = target_sizes[:, 0], target_sizes[:, 1]
    scale = torch.stack([w, h, w, h], -1).to(boxes.dtype)
    return {"scores": scores, "labels": labels,
            "boxes": boxes * scale[:, None, :], "queries": topk_queries}
