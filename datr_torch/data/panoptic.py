"""COCO-panoptic ingestion (port of datr_tpu/data/panoptic.py; reference
datasets/coco_panoptic.py:15-104).

Reads the panoptic annotation JSON and the per-image PNG id maps and offers
CocoDetectionDataset's (image, target) API: each segment's box is the
extent of its mask (util/box_ops.py masks_to_boxes). rgb2id is
panopticapi's R + 256 G + 256^2 B. Images and id maps are decoded by
`coco.open_rgb` (the port's PNG decoder, libjpeg), so no PIL is needed.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from ..utils.rle import encode_mask
from .coco import open_rgb


def rgb2id(color: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 -> [H, W] int32 segment ids."""
    color = color.astype(np.int32)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def masks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """[N, H, W] bool -> [N, 4] xyxy (util/box_ops.py:masks_to_boxes)."""
    if masks.size == 0:
        return np.zeros((0, 4), np.float32)
    n, h, w = masks.shape
    ys = np.arange(h, dtype=np.float32)[None, :, None]
    xs = np.arange(w, dtype=np.float32)[None, None, :]
    # reference returns the INCLUSIVE max index (x_max = max over mask*x,
    # with masked-out pixels contributing 0) — no +1 inflation.
    big = 1e8
    x_min = np.where(masks, xs, big).min(axis=(1, 2))
    x_max = np.where(masks, xs, 0.0).max(axis=(1, 2))
    y_min = np.where(masks, ys, big).min(axis=(1, 2))
    y_max = np.where(masks, ys, 0.0).max(axis=(1, 2))
    return np.stack([x_min, y_min, x_max, y_max], 1).astype(np.float32)


class CocoPanopticDataset:
    """API-compatible with CocoDetectionDataset (load(i) -> (img, target))."""

    def __init__(self, img_folder: str, ann_folder: str, ann_file: str,
                 return_masks: bool = False):
        self.return_masks = return_masks
        with open(ann_file) as f:
            self.coco = json.load(f)
        # align 'images' with 'annotations' by id order
        # (coco_panoptic.py:21-26)
        self.coco["images"] = sorted(self.coco["images"],
                                     key=lambda x: x["id"])
        # sanity check: _ann(idx) indexes 'annotations' by position of the
        # id-sorted images list, so the two must be file_name-aligned
        # (coco_panoptic.py:24-26 guards the same way).
        if self.coco.get("annotations"):
            for img_info, ann in zip(self.coco["images"],
                                     self.coco["annotations"]):
                assert img_info["file_name"][:-4] == ann["file_name"][:-4], (
                    f"panoptic images/annotations misaligned: "
                    f"{img_info['file_name']} vs {ann['file_name']}"
                )
        self.img_folder = img_folder
        self.ann_folder = ann_folder
        self.cats = {c["id"]: c for c in self.coco.get("categories", [])}
        # one-time image_id -> position index (eval_annotations is called
        # once per image per evaluator pass; a linear scan would be O(N^2)
        # per epoch over the val set)
        self._id2idx = {info["id"]: i
                        for i, info in enumerate(self.coco["images"])}

    def __len__(self):
        return len(self.coco["images"])

    def category_ids(self):
        return sorted(self.cats)

    def _ann(self, idx):
        anns = self.coco.get("annotations")
        return anns[idx] if anns else self.coco["images"][idx]

    def load(self, idx: int) -> Tuple[np.ndarray, dict]:
        ann_info = self._ann(idx)
        fname = ann_info["file_name"]
        img_path = os.path.join(self.img_folder,
                                fname.replace(".png", ".jpg"))
        img = open_rgb(img_path)
        h, w = img.shape[:2]

        boxes = np.zeros((0, 4), np.float32)
        labels = np.zeros((0,), np.int64)
        kept_masks = np.zeros((0, h, w), np.uint8)
        if "segments_info" in ann_info:
            id_map = rgb2id(open_rgb(os.path.join(self.ann_folder, fname)))
            segs = ann_info["segments_info"]
            # explicit dtypes: empty segments_info would otherwise produce
            # float64 arrays (np.array([]) defaults to float64 and ~ on it
            # raises TypeError)
            ids = np.array([s["id"] for s in segs], np.int64)
            masks = id_map[None] == ids[:, None, None]
            keep = masks.any(axis=(1, 2)) & ~np.array(
                [bool(s.get("iscrowd", 0)) for s in segs], bool)
            boxes = masks_to_boxes(masks[keep])
            labels = np.array([s["category_id"] for s, k in zip(segs, keep)
                               if k], np.int64)
            if self.return_masks:
                kept_masks = masks[keep].astype(np.uint8)
        image_id = ann_info.get("image_id", ann_info.get("id"))
        target = {
            "boxes": boxes,
            "labels": labels,
            "image_id": int(image_id),
            "orig_size": np.array([h, w], np.int64),
            "size": np.array([h, w], np.int64),
        }
        if self.return_masks:  # reference coco_panoptic.py return_masks
            target["masks"] = kept_masks
        return img, target

    def eval_annotations(self, image_id: int, with_masks: bool = False):
        """Raw GT (crowd kept, segment areas) for evaluation, same contract
        as CocoDetectionDataset.eval_annotations (masks only on request —
        the segm eval path passes with_masks=True)."""
        ann_info = self._ann(self._id2idx[image_id])
        boxes, labels, iscrowd, areas, rles = [], [], [], [], []
        hw = (0, 0)
        if "segments_info" in ann_info:
            id_map = rgb2id(open_rgb(os.path.join(
                self.ann_folder, ann_info["file_name"])))
            hw = id_map.shape
            for s in ann_info["segments_info"]:
                mask = id_map == s["id"]
                if not mask.any():
                    continue
                b = masks_to_boxes(mask[None])[0]
                boxes.append(b)
                labels.append(s["category_id"])
                iscrowd.append(bool(s.get("iscrowd", 0)))
                areas.append(float(s.get("area", mask.sum())))
                if with_masks:
                    rles.append(encode_mask(mask))
        out = {
            "boxes": np.asarray(boxes, np.float64).reshape(-1, 4),
            "labels": np.asarray(labels, np.int64),
            "iscrowd": np.asarray(iscrowd, bool),
            "areas": np.asarray(areas, np.float64),
        }
        if with_masks:
            out["masks"] = rles
            out["mask_size"] = tuple(int(x) for x in hw)
        return out
