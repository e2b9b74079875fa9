"""Detection visualizers (port of datr_tpu/utils/visualizer.py): boxes and
instance masks drawn on an image, the pseudo-label debug picture. They need
PIL, which each function imports when it is called, so that importing the
package never does (the card's machine may lack it)."""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
from .boxes import box_cxcywh_to_xyxy

PALETTE = [
    (255, 99, 71), (65, 105, 225), (60, 179, 113), (238, 130, 238),
    (255, 165, 0), (106, 90, 205), (64, 224, 208), (218, 165, 32),
    (199, 21, 133), (0, 191, 255), (154, 205, 50), (255, 20, 147),
]


def _cxcywh_to_xyxy(b) -> np.ndarray:
    return box_cxcywh_to_xyxy(torch.from_numpy(
        np.asarray(b, np.float32))).numpy()


def denormalize_image(arr: np.ndarray):
    """[H, W, 3] normalized float -> PIL RGB image (the inverse of the
    data pipeline's normalization)."""
    from PIL import Image

    img = (arr * IMAGENET_STD + IMAGENET_MEAN) * 255.0
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), "RGB")


def draw_boxes(
    img,
    boxes_xyxy: np.ndarray,
    labels: Optional[np.ndarray] = None,
    scores: Optional[np.ndarray] = None,
    class_names: Optional[Sequence[str]] = None,
    width: int = 2,
):
    """A copy of the PIL image `img` with the boxes (pixels, xyxy) drawn
    in per-class palette colours, each with its class name or label and
    score where given."""
    from PIL import ImageDraw

    out = img.copy()
    d = ImageDraw.Draw(out)
    for i, b in enumerate(np.asarray(boxes_xyxy)):
        lab = int(labels[i]) if labels is not None else 0
        color = PALETTE[lab % len(PALETTE)]
        d.rectangle([float(b[0]), float(b[1]), float(b[2]), float(b[3])],
                    outline=color, width=width)
        txt = []
        if class_names and 0 <= lab < len(class_names):
            txt.append(class_names[lab])
        elif labels is not None:
            txt.append(str(lab))
        if scores is not None:
            txt.append(f"{float(scores[i]):.2f}")
        if txt:
            d.text((float(b[0]) + 2, max(0.0, float(b[1]) - 12)),
                   ":".join(txt), fill=color)
    return out


def draw_masks(
    img,
    masks: np.ndarray,  # [N, H, W] binary, the image's size
    labels: Optional[np.ndarray] = None,
    alpha: float = 0.45,
):
    """A copy of the PIL image `img` with the instance masks alpha-blended
    in per-class palette colours (by index where `labels` is None)."""
    from PIL import Image

    base = np.asarray(img.copy(), np.float32)
    for i, m in enumerate(np.asarray(masks)):
        if m.shape != base.shape[:2]:
            raise ValueError(f"mask {i} shape {m.shape} != image "
                             f"{base.shape[:2]}")
        lab = int(labels[i]) if labels is not None else i
        color = np.array(PALETTE[lab % len(PALETTE)], np.float32)
        sel = np.asarray(m, bool)
        base[sel] = (1 - alpha) * base[sel] + alpha * color
    return Image.fromarray(np.clip(base, 0, 255).astype(np.uint8), "RGB")


def save_pseudo_label_debug(
    image_norm: np.ndarray,  # [H, W, 3] normalized (the target's weak view)
    pseudo: Dict[str, np.ndarray],  # boxes (cxcywh, fractions of the
    # real size), labels, valid
    gt: Optional[Dict[str, np.ndarray]],
    real_hw,
    out_path: str,
):
    """The pseudo-labels beside the ground truth (left / right), saved to
    `out_path`; the pseudo-labels alone where `gt` is None. Returns the
    PIL image."""
    from PIL import Image

    img = denormalize_image(image_norm)
    h, w = int(real_hw[0]), int(real_hw[1])
    scale = np.array([w, h, w, h], np.float32)

    pv = np.asarray(pseudo["valid"], bool)
    p_boxes = _cxcywh_to_xyxy(np.asarray(pseudo["boxes"])[pv]) * scale
    left = draw_boxes(img, p_boxes, np.asarray(pseudo["labels"])[pv])

    if gt is not None:
        gv = np.asarray(gt["valid"], bool)
        g_boxes = _cxcywh_to_xyxy(np.asarray(gt["boxes"])[gv]) * scale
        right = draw_boxes(img, g_boxes, np.asarray(gt["labels"])[gv])
        canvas = Image.new("RGB", (img.width * 2 + 8, img.height),
                           (255, 255, 255))
        canvas.paste(left, (0, 0))
        canvas.paste(right, (img.width + 8, 0))
    else:
        canvas = left
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    canvas.save(out_path)
    return canvas
