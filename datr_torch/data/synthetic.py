"""Synthetic detection data: class-coloured rectangles on noise (numpy-only
copy of datr_tpu/data/synthetic.py:22-70, pixel-equal to it: the same
`random.Random` and numpy seeds, rectangles filled with PIL's inclusive
corners, the same fog), and `synthetic_da_batch`, the paired batch of the
burn-in step on a static canvas, normalized as datr_tpu's finalize_example
does (datr_tpu/data/transforms.py:215-285). No augmentation."""

from __future__ import annotations

import random
from typing import Dict, Tuple

import numpy as np
import torch

from .. import native, resolve_device
from .transforms import IMAGENET_MEAN, IMAGENET_STD

CLASS_COLORS = [
    (220, 40, 40), (40, 220, 40), (40, 40, 220), (220, 220, 40),
    (220, 40, 220), (40, 220, 220), (240, 140, 20), (140, 20, 240),
]


class SyntheticDetectionDataset:
    """load(i) -> (uint8 image [h, w, 3], target with xyxy pixel `boxes`
    and 1-based `labels`). At most len(CLASS_COLORS) classes."""

    def __init__(self, n_images=16, hw=(240, 320), num_classes=4,
                 max_objects=4, seed=0, fog: float = 0.0):
        if num_classes > len(CLASS_COLORS):
            raise ValueError(f"at most {len(CLASS_COLORS)} classes")
        self.n = n_images
        self.hw = hw
        self.num_classes = num_classes
        self.max_objects = max_objects
        self.seed = seed
        self.fog = fog

    def __len__(self):
        return self.n

    def load(self, i: int):
        rng = random.Random(self.seed * 100003 + i)
        h, w = self.hw
        npr = np.random.default_rng(self.seed * 7 + i)
        img = npr.integers(80, 120, (h, w, 3), dtype=np.uint8)
        n_obj = rng.randint(1, self.max_objects)
        boxes, labels = [], []
        for _ in range(n_obj):
            bw = rng.randint(w // 10, w // 3)
            bh = rng.randint(h // 10, h // 3)
            x0 = rng.randint(0, w - bw - 1)
            y0 = rng.randint(0, h - bh - 1)
            cls = rng.randint(1, self.num_classes)
            # PIL's rectangle fills both corners inclusive
            img[y0:y0 + bh + 1, x0:x0 + bw + 1] = CLASS_COLORS[cls - 1]
            boxes.append([x0, y0, x0 + bw, y0 + bh])
            labels.append(cls)
        if self.fog > 0:  # target domain: washed-out, low contrast
            arr = img.astype(np.float32) * (1 - self.fog) + 255.0 * self.fog
            img = arr.astype(np.uint8)
        target = {
            "boxes": np.asarray(boxes, np.float32),
            "labels": np.asarray(labels, np.int64),
            "image_id": i,
            "orig_size": np.array([h, w], np.int64),
            "size": np.array([h, w], np.int64),
        }
        return img, target


def finalize(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
             canvas_hw: Tuple[int, int], max_boxes: int):
    """One image onto the canvas: (normalized f32 [H, W, 3] with zero pads,
    pad_mask [H, W], cxcywh boxes [max_boxes, 4] normalized by the real
    size, labels, valid). Images larger than the canvas are scaled down
    through the uint8 resize of `native.resize_pad_u8` (datr_tpu resizes in
    f32, so a scaled image differs by the u8 rounding; one that fits is
    exact)."""
    H, W = canvas_hw
    h, w = img.shape[:2]
    if h > H or w > W:
        scale = min(H / h, W / w)
        boxes = boxes * scale
        h, w = int(h * scale), int(w * scale)
    u8 = native.resize_pad_u8(img, (h, w), canvas_hw)
    canvas = ((u8.astype(np.float64) / 255.0 - IMAGENET_MEAN)
              / IMAGENET_STD).astype(np.float32)
    canvas[h:] = 0.0
    canvas[:, w:] = 0.0
    pad_mask = np.ones((H, W), bool)
    pad_mask[:h, :w] = False
    out_boxes = np.zeros((max_boxes, 4), np.float32)
    out_labels = np.zeros((max_boxes,), np.int64)
    valid = np.zeros((max_boxes,), bool)
    n = min(len(boxes), max_boxes)
    if n:
        b = boxes[:n].astype(np.float32)
        out_boxes[:n] = np.stack([(b[:, 0] + b[:, 2]) / 2.0 / w,
                                  (b[:, 1] + b[:, 3]) / 2.0 / h,
                                  (b[:, 2] - b[:, 0]) / w,
                                  (b[:, 3] - b[:, 1]) / h], 1)
        out_labels[:n] = labels[:n]
        valid[:n] = True
    return canvas, pad_mask, out_boxes, out_labels, valid


def synthetic_da_batch(source: SyntheticDetectionDataset,
                       target: SyntheticDetectionDataset, indices,
                       canvas_hw: Tuple[int, int], max_boxes: int = 100,
                       device=None) -> Dict[str, torch.Tensor]:
    """The burn-in step's batch from images `indices` of each domain:
    images [2b, H, W, 3] (b source, then b target), pad_mask [2b, H, W],
    and the source half's boxes [b, T, 4], labels [b, T], valid [b, T], on
    `device` (default: the CUDA card)."""
    dev = resolve_device(device)
    src = [finalize(*_img_boxes_labels(source, i), canvas_hw, max_boxes)
           for i in indices]
    tgt = [finalize(*_img_boxes_labels(target, i), canvas_hw, max_boxes)
           for i in indices]
    batch = {
        "images": np.stack([s[0] for s in src] + [t[0] for t in tgt]),
        "pad_mask": np.stack([s[1] for s in src] + [t[1] for t in tgt]),
        "boxes": np.stack([s[2] for s in src]),
        "labels": np.stack([s[3] for s in src]),
        "valid": np.stack([s[4] for s in src]),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _img_boxes_labels(ds: SyntheticDetectionDataset, i: int):
    img, t = ds.load(i)
    return img, t["boxes"], t["labels"]
