"""Synthetic detection data: class-coloured rectangles on noise (numpy-only
copy of datr_tpu/data/synthetic.py, pixel-equal to it: the same
`random.Random` and numpy seeds, rectangles filled with PIL's inclusive
corners, the same fog); `synthetic_da_pair`, the paired dataset of the CLI's
--synthetic runs; and two batch helpers over the loaders' batch assembly,
without geometric augmentation: `synthetic_da_batch`, the training steps'
paired batch on a static canvas (`finalize_example`, with `strong_augment`
of the target half for self-training), and `synthetic_eval_batches`."""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import resolve_device
from .loader import EvalLoader, da_batch, to_device
from .strong_aug import strong_augment
from .transforms import finalize_example

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
        self.categories = list(range(1, num_classes + 1))

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


def synthetic_da_pair(n_images=16, hw=(240, 320), num_classes=4, seed=0):
    """The --synthetic training set: a source dataset and a fogged target
    one (datr_tpu/data/synthetic.py:73-79)."""
    from .coco import DAPairedDataset

    src = SyntheticDetectionDataset(n_images, hw, num_classes, seed=seed)
    tgt = SyntheticDetectionDataset(n_images, hw, num_classes, seed=seed + 1,
                                    fog=0.35)
    return DAPairedDataset(src, tgt, strong_aug=True)


def synthetic_da_batch(source: SyntheticDetectionDataset,
                       target: SyntheticDetectionDataset, indices,
                       canvas_hw: Tuple[int, int], max_boxes: int = 100,
                       device=None, strong: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """The training step's batch from images `indices` of each domain:
    make_da_loader's batch (`da_batch`) without its geometric augmentation,
    on `device` (default: the CUDA card). Without `strong` it holds images,
    pad_mask, boxes, labels and valid; with it, as the self-training step
    takes it, also images_strong (the target half `strong_augment` of each
    target image, drawn from `random.Random(target.seed * 100003 + i)`) and
    real_sizes."""
    src = [finalize_example(*source.load(i), canvas_hw, max_boxes)
           for i in indices]
    tgt_raw = [target.load(i) for i in indices]
    tgt = [finalize_example(img, t, canvas_hw, max_boxes)
           for img, t in tgt_raw]
    views = [finalize_example(
        strong_augment(img, random.Random(target.seed * 100003 + i)),
        None, canvas_hw, max_boxes)
        for i, (img, _) in zip(indices, tgt_raw)] if strong else None
    batch = da_batch(src, tgt, views)
    if not strong:
        del batch["images_strong"], batch["real_sizes"]
    return to_device(batch, resolve_device(device))


def synthetic_eval_batches(dataset: SyntheticDetectionDataset,
                           batch_size: int, canvas_hw: Tuple[int, int],
                           max_boxes: int = 100, device=None
                           ) -> List[Dict[str, torch.Tensor]]:
    """Every image of `dataset` in EvalLoader's batches, without a
    transform, on `device` (default: the CUDA card)."""
    dev = resolve_device(device)
    return [to_device(b, dev) for b in EvalLoader(
        dataset, batch_size, canvas_hw, lambda img, tgt: (img, tgt),
        max_boxes, num_threads=1)]
