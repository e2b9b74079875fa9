"""Box conversions, IoU and GIoU (port of datr_tpu/utils/boxes.py:15-82).
Shape-polymorphic over leading dims; degenerate boxes are safe (areas and
unions are clamped), and callers mask invalid entries."""

from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1
    )


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack(
        [(x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0], dim=-1
    )


def box_area(b: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes [..., 4] -> [...]."""
    return ((b[..., 2] - b[..., 0]).clamp(min=0)
            * (b[..., 3] - b[..., 1]).clamp(min=0))


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Pairwise IoU between xyxy boxes [..., N, 4] x [..., M, 4] ->
    ([..., N, M] IoU, [..., N, M] union)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union.clamp(min=1e-8), union


def generalized_box_iou(boxes1: torch.Tensor,
                        boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU between xyxy boxes [..., N, 4] x [..., M, 4] ->
    [..., N, M], in [-1, 1]."""
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp(min=1e-8)


def box_iou_elementwise(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """IoU between aligned xyxy boxes [..., 4] x [..., 4] -> ([...], [...]
    union)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    return inter / union.clamp(min=1e-8), union


def generalized_box_iou_elementwise(boxes1: torch.Tensor,
                                    boxes2: torch.Tensor) -> torch.Tensor:
    """GIoU between aligned xyxy boxes -> [...] (the loss needs only the
    diagonal of the pairwise matrix)."""
    iou, union = box_iou_elementwise(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp(min=1e-8)
