"""Synthetic detection data: class-coloured rectangles on noise (numpy-only
copy of datr_tpu/data/synthetic.py:22-70, pixel-equal to it: the same
`random.Random` and numpy seeds, rectangles filled with PIL's inclusive
corners, the same fog); `synthetic_da_batch`, the paired batch of the
training steps on a static canvas, normalized as datr_tpu's finalize_example
does (datr_tpu/data/transforms.py:215-285), with a photometric strong view
of the target half for self-training; and `synthetic_eval_batches`. No
geometric augmentation."""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

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
    size, labels, valid, the real (h, w) on the canvas). Images larger
    than the canvas are scaled down through the uint8 resize of
    `native.resize_pad_u8` (datr_tpu resizes in f32, so a scaled image
    differs by the u8 rounding; one that fits is exact)."""
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
    return (canvas, pad_mask, out_boxes, out_labels, valid,
            np.array([h, w], np.int64))


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    """uint8 image scaled by `factor` (own copy of
    datr_tpu/data/strong_aug.py:102-105, on the array)."""
    arr = np.clip(np.asarray(img, np.float32) / 255.0 * factor, 0, 1)
    return (arr * 255 + 0.5).astype(np.uint8)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """uint8 image pulled to / pushed from its per-channel mean (own copy of
    datr_tpu/data/strong_aug.py:18-20, :96-99, on the array)."""
    arr = np.asarray(img, np.float32) / 255.0
    mean = arr.mean(axis=(0, 1), keepdims=True)
    arr = np.clip((arr - mean) * factor + mean, 0, 1)
    return (arr * 255 + 0.5).astype(np.uint8)


def strong_view(img: np.ndarray, seed: int) -> np.ndarray:
    """A photometric view of a uint8 image: brightness, then contrast, each
    by a seeded factor in [0.6, 1.4] (ColorJitter's 0.4 range). Geometry is
    unchanged, so the weak view's boxes hold for it. The strong chain's
    saturation, hue, grayscale and blur need PIL and are not copied."""
    f_b, f_c = np.random.default_rng(seed).uniform(0.6, 1.4, 2)
    return adjust_contrast(adjust_brightness(img, f_b), f_c)


def synthetic_da_batch(source: SyntheticDetectionDataset,
                       target: SyntheticDetectionDataset, indices,
                       canvas_hw: Tuple[int, int], max_boxes: int = 100,
                       device=None, strong: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """The training step's batch from images `indices` of each domain:
    images [2b, H, W, 3] (b source, then b target), pad_mask [2b, H, W],
    and the source half's boxes [b, T, 4], labels [b, T], valid [b, T], on
    `device` (default: the CUDA card). With `strong`, as the self-training
    step takes it (datr_tpu/data/loader.py:64-90), also images_strong
    [2b, H, W, 3] (the source half its weak view, the target half
    `strong_view` of each target image) and real_sizes [b, 2] (the target
    half's unpadded (h, w))."""
    dev = resolve_device(device)
    src = [finalize(*_img_boxes_labels(source, i), canvas_hw, max_boxes)
           for i in indices]
    tgt_raw = [_img_boxes_labels(target, i) for i in indices]
    tgt = [finalize(*r, canvas_hw, max_boxes) for r in tgt_raw]
    batch = {
        "images": np.stack([s[0] for s in src] + [t[0] for t in tgt]),
        "pad_mask": np.stack([s[1] for s in src] + [t[1] for t in tgt]),
        "boxes": np.stack([s[2] for s in src]),
        "labels": np.stack([s[3] for s in src]),
        "valid": np.stack([s[4] for s in src]),
    }
    if strong:
        views = [finalize(strong_view(img, target.seed * 100003 + i), b, lab,
                          canvas_hw, max_boxes)[0]
                 for i, (img, b, lab) in zip(indices, tgt_raw)]
        batch["images_strong"] = np.stack([s[0] for s in src] + views)
        batch["real_sizes"] = np.stack([t[5] for t in tgt])
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def synthetic_eval_batches(dataset: SyntheticDetectionDataset,
                           batch_size: int, canvas_hw: Tuple[int, int],
                           max_boxes: int = 100, device=None
                           ) -> List[Dict[str, torch.Tensor]]:
    """Every image of `dataset` in eval batches with the keys datr_tpu's
    EvalLoader yields (datr_tpu/data/loader.py:226-300): images, pad_mask,
    orig_sizes (f32), image_ids, batch_valid, boxes, labels, valid,
    real_sizes. The last batch is filled by repeating the last image,
    marked not valid in batch_valid. On `device` (default: the CUDA
    card)."""
    dev = resolve_device(device)
    n = len(dataset)
    out = []
    for start in range(0, max(n, 1), batch_size):
        idxs = list(range(start, min(start + batch_size, n)))
        valid = np.zeros(batch_size, bool)
        valid[:len(idxs)] = True
        idxs += [max(n - 1, 0)] * (batch_size - len(idxs))
        items, orig, ids = [], [], []
        for i in idxs:
            img, t = dataset.load(i)
            items.append(finalize(img, t["boxes"], t["labels"], canvas_hw,
                                  max_boxes))
            orig.append(t["orig_size"])
            ids.append(t["image_id"])
        batch = {
            "images": np.stack([x[0] for x in items]),
            "pad_mask": np.stack([x[1] for x in items]),
            "orig_sizes": np.stack(orig).astype(np.float32),
            "image_ids": np.asarray(ids, np.int64),
            "batch_valid": valid,
            "boxes": np.stack([x[2] for x in items]),
            "labels": np.stack([x[3] for x in items]),
            "valid": np.stack([x[4] for x in items]),
            "real_sizes": np.stack([x[5] for x in items]),
        }
        out.append({k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    return out


def _img_boxes_labels(ds: SyntheticDetectionDataset, i: int):
    img, t = ds.load(i)
    return img, t["boxes"], t["labels"]
