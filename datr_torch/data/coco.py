"""COCO-format detection datasets and the source/target DA pairing (port of
datr_tpu/data/coco.py; images are uint8 [H, W, 3] arrays).

The COCO JSON is parsed directly; annotations are filtered as the
reference's ConvertCocoPolysToMask does: crowd dropped, boxes clamped to the
image, degenerate ones dropped. Labels are the raw category_id. With
`return_masks` the targets carry each kept annotation's instance mask
(`decode_segmentation`: RLE through utils/rle.py, polygons rasterized as
Pillow's ImageDraw.polygon fills them, `pil_ops.polygon_fill`). The
panoptic layout is data/panoptic.py.
"""

from __future__ import annotations

import io
import json
import os
import random
from typing import Dict, List

import numpy as np

from .. import native
from ..utils.rle import counts_from_string, decode_counts, encode_mask
from . import pil_ops, png
from .strong_aug import strong_augment


def decode_rgb(data: bytes) -> np.ndarray:
    """Encoded image bytes -> uint8 [H, W, 3] RGB, as PIL's
    `.convert("RGB")` gives it: JPEG through libjpeg (`native.
    decode_jpeg_rgb`), PNG through the port's decoder (`png.
    decode_png_rgb`), any other format through PIL, imported here and
    nowhere else in the package (the card's machine has none). A JPEG
    goes to PIL too where this machine has no libjpeg to build against."""
    why = ""
    try:
        img = native.decode_jpeg_rgb(data)
    except RuntimeError as e:
        img, why = None, f" ({e})"
    if img is None:
        img = png.decode_png_rgb(data)
    if img is not None:
        return img
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decoding an image that is neither a JPEG libjpeg reads nor an "
            "8-bit PNG needs PIL, which this machine lacks (other formats: "
            f"ROADMAP §A, image formats){why}") from e
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def open_rgb(path: str) -> np.ndarray:
    """Decode an image file to uint8 [H, W, 3] RGB (`decode_rgb`)."""
    with open(path, "rb") as f:
        return decode_rgb(f.read())


def _rle_counts(seg: dict) -> np.ndarray:
    c = seg["counts"]
    return np.asarray(counts_from_string(c) if isinstance(c, (str, bytes))
                      else c, np.int64)


def decode_segmentation(seg, h: int, w: int) -> np.ndarray:
    """A COCO 'segmentation' field -> binary mask [h, w] uint8: an RLE dict
    (compressed or not, column-major runs from background) decoded, a list
    of polygons filled as datr_tpu fills them through PIL's
    ImageDraw.polygon (datr_tpu/data/coco.py:40-71; polygons of fewer
    than 3 points are skipped). An RLE of another size than the image
    raises."""
    if isinstance(seg, dict):
        rh, rw = seg.get("size", (h, w))
        if (int(rh), int(rw)) != (h, w):
            raise ValueError(
                f"RLE size {(rh, rw)} != image size {(h, w)}: re-encode the "
                "annotation at the image resolution")
        return decode_counts(_rle_counts(seg), rh, rw).astype(np.uint8)
    out = np.zeros((h, w), np.uint8)
    for poly in seg:
        if len(poly) >= 6:
            out |= pil_ops.polygon_fill([float(v) for v in poly], h, w)
    return out


class CocoIndex:
    """Minimal in-memory COCO index (replaces pycocotools.coco.COCO)."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            data = json.load(f)
        self.images = {im["id"]: im for im in data["images"]}
        self.image_ids = [im["id"] for im in data["images"]]
        self.cats = {c["id"]: c for c in data.get("categories", [])}
        self.anns_by_image: Dict[int, List[dict]] = {
            i: [] for i in self.image_ids
        }
        for a in data.get("annotations", []):
            if a["image_id"] in self.anns_by_image:
                self.anns_by_image[a["image_id"]].append(a)


class CocoDetectionDataset:
    """Single-domain detection dataset: load(i) -> (image, target); with
    `return_masks` the target's `masks` [N, h, w] uint8 align with its
    boxes and labels."""

    def __init__(self, img_dir: str, ann_file: str,
                 return_masks: bool = False):
        self.img_dir = img_dir
        self.index = CocoIndex(ann_file)
        self.return_masks = return_masks

    def __len__(self):
        return len(self.index.image_ids)

    def category_ids(self):
        """Sorted GT category ids (main builds the evaluator's category
        list from this)."""
        return sorted(self.index.cats)

    def load(self, i: int):
        image_id = self.index.image_ids[i]
        info = self.index.images[image_id]
        img = open_rgb(os.path.join(self.img_dir, info["file_name"]))
        h, w = img.shape[:2]

        boxes, labels, masks = [], [], []
        for a in self.index.anns_by_image[image_id]:
            if a.get("iscrowd", 0):
                continue
            x, y, bw, bh = a["bbox"]  # xywh
            x0 = max(0.0, min(x, w))
            y0 = max(0.0, min(y, h))
            x1 = max(0.0, min(x + bw, w))
            y1 = max(0.0, min(y + bh, h))
            if x1 <= x0 or y1 <= y0:
                continue
            boxes.append([x0, y0, x1, y1])
            labels.append(a["category_id"])
            if self.return_masks:
                masks.append(decode_segmentation(
                    a.get("segmentation", []), h, w))
        target = {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int64),
            "image_id": image_id,
            "orig_size": np.array([h, w], np.int64),
            "size": np.array([h, w], np.int64),
        }
        if self.return_masks:
            target["masks"] = (np.stack(masks) if masks
                               else np.zeros((0, h, w), np.uint8))
        return img, target

    def eval_annotations(self, image_id: int, with_masks: bool = False):
        """Raw GT for COCO evaluation: unlike the training targets, crowd
        annotations are kept (they become ignore regions in the evaluator)
        and the annotation's 'area' is used when present, as the
        reference's evaluation against the COCO API GT does. `with_masks`
        (the segm evaluation asks for it) adds each annotation's RLE
        counts (`masks`) and the image's (h, w) (`mask_size`)."""
        boxes, labels, iscrowd, areas, segs = [], [], [], [], []
        for a in self.index.anns_by_image[image_id]:
            x, y, bw, bh = a["bbox"]
            boxes.append([x, y, x + bw, y + bh])
            labels.append(a["category_id"])
            iscrowd.append(bool(a.get("iscrowd", 0)))
            areas.append(float(a.get("area", bw * bh)))
            segs.append(a.get("segmentation", []))
        out = {
            "boxes": np.asarray(boxes, np.float64).reshape(-1, 4),
            "labels": np.asarray(labels, np.int64),
            "iscrowd": np.asarray(iscrowd, bool),
            "areas": np.asarray(areas, np.float64),
        }
        if with_masks:
            info = self.index.images[image_id]
            h, w = int(info["height"]), int(info["width"])
            out["masks"] = [
                _rle_counts(seg) if isinstance(seg, dict)
                else encode_mask(decode_segmentation(seg, h, w))
                for seg in segs]
            out["mask_size"] = (h, w)
        return out


class ConcatDetectionDataset:
    """Several COCO-format shards presented as one dataset (the 'o365'
    layout's annotation shards)."""

    def __init__(self, parts: List[CocoDetectionDataset]):
        assert parts, "ConcatDetectionDataset needs at least one shard"
        self.parts = parts
        self._cum = np.cumsum([len(p) for p in parts])

    def __len__(self):
        return int(self._cum[-1])

    def category_ids(self):
        ids = set()
        for p in self.parts:
            ids.update(p.category_ids())
        return sorted(ids)

    def _locate(self, i: int):
        p = int(np.searchsorted(self._cum, i, side="right"))
        prev = 0 if p == 0 else int(self._cum[p - 1])
        return self.parts[p], i - prev

    def load(self, i: int):
        part, j = self._locate(i)
        return part.load(j)

    def eval_annotations(self, image_id: int, with_masks: bool = False):
        for p in self.parts:
            if image_id in p.index.anns_by_image:
                return p.eval_annotations(image_id, with_masks=with_masks)
        raise KeyError(image_id)


class DAPairedDataset:
    """Zip of source + target datasets with modulo indexing, len = max.
    load returns (src_img, src_strong, src_tgt, tgt_img, tgt_strong,
    tgt_tgt)."""

    def __init__(self, source, target, strong_aug: bool = True):
        self.source = source
        self.target = target
        self.strong_aug = strong_aug

    def __len__(self):
        return max(len(self.source), len(self.target))

    def load(self, i: int, rng: random.Random, strong: bool = True):
        s_img, s_tgt = self.source.load(i % len(self.source))
        t_img, t_tgt = self.target.load(i % len(self.target))
        # the strong view is the target domain's only: the student's strong
        # input is [source weak ; target strong]. `strong=False` (burn-in
        # epochs, which never read it) skips the work.
        do_strong = self.strong_aug and strong
        s_strong = s_img
        t_strong = strong_augment(t_img, rng) if do_strong else t_img
        return s_img, s_strong, s_tgt, t_img, t_strong, t_tgt


# -----------------------------------------------------------------------
# dataset registry: every name maps onto a documented layout under
# data_root (datr_tpu/data/coco.py:263-395)
# -----------------------------------------------------------------------
def build_coco_classic(image_set: str, root: str,
                       return_masks: bool = False):
    """Classic COCO-2017 layout: <root>/{train2017,val2017} +
    annotations/instances_*.json."""
    split = "train2017" if image_set == "train" else "val2017"
    return CocoDetectionDataset(
        os.path.join(root, split),
        os.path.join(root, "annotations", f"instances_{split}.json"),
        return_masks=return_masks,
    )


def build_coco_panoptic(image_set: str, root: str,
                        return_masks: bool = False):
    """COCO-panoptic layout: <root>/{train2017,val2017} +
    <root>/panoptic/{panoptic_<split>/, annotations/panoptic_<split>.json}."""
    from .panoptic import CocoPanopticDataset

    split = "train2017" if image_set == "train" else "val2017"
    pan = os.path.join(root, "panoptic")
    return CocoPanopticDataset(
        os.path.join(root, split), os.path.join(pan, f"panoptic_{split}"),
        os.path.join(pan, "annotations", f"panoptic_{split}.json"),
        return_masks=return_masks)


def build_o365_combine(image_set: str, root: str,
                       return_masks: bool = False):
    """Objects365-style layout: <root>/<split>/images plus one
    annotations.json or several annotations*.json shards, combined."""
    import glob

    split = "train" if image_set == "train" else "val"
    d = os.path.join(root, split)
    shards = sorted(glob.glob(os.path.join(d, "annotations*.json")))
    if not shards:
        raise FileNotFoundError(
            f"no annotations*.json under {d} (o365 layout)")
    parts = [CocoDetectionDataset(os.path.join(d, "images"), s,
                                  return_masks=return_masks) for s in shards]
    if len(parts) == 1:
        return parts[0]
    return ConcatDetectionDataset(parts)


def build_dataset(
    image_set: str,
    dataset_file: str,
    data_root: str,
    strong_aug: bool = True,
    return_masks: bool = False,
):
    """image_set: 'train' (paired DA, or single-domain) or 'val'.

      'coco'          classic COCO-2017 tree (build_coco_classic)
      'coco_panoptic' panoptic tree (build_coco_panoptic)
      'o365'          sharded-annotations tree (build_o365_combine)
      any other name  <data_root>/<name>/ with either
                        source/{images,annotations.json},
                        target/{images,annotations.json} and
                        val/{images,annotations.json} (paired DA),
                      or train/{images,annotations.json} (+ val/) for
                      single-domain training.
    `return_masks` adds instance masks to the targets; the paired DA layout
    carries none (its training raises, as datr_tpu's does).
    """
    kw = dict(return_masks=return_masks)
    if dataset_file == "coco":
        return build_coco_classic(image_set, os.path.join(data_root, "coco"),
                                  **kw)
    if dataset_file == "coco_panoptic":
        return build_coco_panoptic(image_set,
                                   os.path.join(data_root, "coco"), **kw)
    if dataset_file == "o365":
        return build_o365_combine(image_set, os.path.join(data_root, "o365"),
                                  **kw)
    d = os.path.join(data_root, dataset_file)
    single_domain = (
        not os.path.isdir(os.path.join(d, "source"))
        and os.path.isdir(os.path.join(d, "train"))
    )
    if image_set == "train":
        if single_domain:
            return CocoDetectionDataset(
                os.path.join(d, "train/images"),
                os.path.join(d, "train/annotations.json"), **kw)
        if return_masks:
            # the reference's DA pipeline carries no instance masks: a
            # mask head trained there would get no gradient
            raise ValueError(
                "masks=True requires a single-domain dataset layout "
                "(train/ + val/): the paired DA pipeline carries no "
                "instance masks")
        src = CocoDetectionDataset(
            os.path.join(d, "source/images"),
            os.path.join(d, "source/annotations.json"),
        )
        tgt = CocoDetectionDataset(
            os.path.join(d, "target/images"),
            os.path.join(d, "target/annotations.json"),
        )
        return DAPairedDataset(src, tgt, strong_aug)
    if image_set == "val":
        return CocoDetectionDataset(
            os.path.join(d, "val/images"),
            os.path.join(d, "val/annotations.json"), **kw)
    raise ValueError(image_set)
