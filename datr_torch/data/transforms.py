"""The paired weak-augmentation pipeline and the static canvas (port of
datr_tpu/data/transforms.py on uint8 [H, W, 3] arrays; PIL's resize, flip
and crop come from `pil_ops`).

Every train transform acts on an (img, img_strong, target) triple, so the
strong photometric view gets the same geometry: HFlip + RandomSelect(
multi-scale resize | resize -> RandomSizeCrop -> resize); eval is one
resize. `finalize_example` normalizes and pads to one static canvas. Targets
hold xyxy pixel `boxes` and, with instance masks, `masks` [N, h, w] uint8,
which follow the geometry (nearest resize, flip, crop) and leave
`finalize_example` as soft f16 targets at 1 / `mask_stride` of the canvas.
"""

from __future__ import annotations

import random
from typing import Dict, Optional, Tuple

import numpy as np

from .. import native
from . import pil_ops

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

def get_size_with_aspect_ratio(
    image_size: Tuple[int, int], size: int, max_size: Optional[int] = None
) -> Tuple[int, int]:
    """(w, h) -> output (h, w): short side `size`, long side capped."""
    w, h = image_size
    if max_size is not None:
        min_original = float(min(w, h))
        max_original = float(max(w, h))
        if max_original / min_original * size > max_size:
            size = int(round(max_size * min_original / max_original))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        ow = size
        oh = int(size * h / w)
    else:
        oh = size
        ow = int(size * w / h)
    return oh, ow


def _wh(img: np.ndarray) -> Tuple[int, int]:
    return img.shape[1], img.shape[0]


def _nearest_idx(n_out: int, n_in: int) -> np.ndarray:
    """torch's nearest index map floor(i * scale), the scale and the product
    in float32 as ATen computes them (datr_tpu/data/transforms.py:45-55)."""
    scale = np.float32(n_in) / np.float32(n_out)
    idx = np.floor(np.arange(n_out, dtype=np.float32) * scale).astype(
        np.int64)
    return np.minimum(idx, n_in - 1)


def _resize_masks(masks: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """[N, h, w] uint8 -> [N, oh, ow], nearest."""
    if masks.shape[0] == 0:
        return np.zeros((0, oh, ow), masks.dtype)
    yi = _nearest_idx(oh, masks.shape[1])
    xi = _nearest_idx(ow, masks.shape[2])
    return masks[:, yi[:, None], xi[None, :]]


def _resize_triple(img, img_strong, target, size, max_size=None):
    w, h = _wh(img)
    oh, ow = get_size_with_aspect_ratio((w, h), size, max_size)
    rw, rh = ow / w, oh / h
    img = pil_ops.resize_bilinear(img, (ow, oh))
    if img_strong is not None:
        img_strong = pil_ops.resize_bilinear(img_strong, (ow, oh))
    if target is not None and len(target.get("boxes", [])):
        b = target["boxes"].copy()  # xyxy absolute
        b[:, [0, 2]] *= rw
        b[:, [1, 3]] *= rh
        target = dict(target, boxes=b)
    if target is not None:
        target = dict(target, size=np.array([oh, ow], np.int64))
        if target.get("masks") is not None:
            target["masks"] = _resize_masks(target["masks"], oh, ow)
    return img, img_strong, target


def _hflip_triple(img, img_strong, target):
    img = pil_ops.hflip(img)
    if img_strong is not None:
        img_strong = pil_ops.hflip(img_strong)
    w = _wh(img)[0]
    if target is not None and len(target.get("boxes", [])):
        b = target["boxes"].copy()
        b = b[:, [2, 1, 0, 3]] * np.array([-1, 1, -1, 1]) + np.array(
            [w, 0, w, 0])
        target = dict(target, boxes=b.astype(np.float32))
    if target is not None and target.get("masks") is not None:
        target = dict(target, masks=target["masks"][:, :, ::-1])
    return img, img_strong, target


def _crop_triple(img, img_strong, target, region):
    """region: (top, left, h, w)."""
    top, left, h, w = region
    img = pil_ops.crop(img, (left, top, left + w, top + h))
    if img_strong is not None:
        img_strong = pil_ops.crop(img_strong, (left, top, left + w, top + h))
    if target is not None:
        t = dict(target, size=np.array([h, w], np.int64))
        if len(target.get("boxes", [])):
            b = target["boxes"].copy() - np.array([left, top, left, top],
                                                  np.float32)
            b[:, 0::2] = b[:, 0::2].clip(0, w)
            b[:, 1::2] = b[:, 1::2].clip(0, h)
            keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
            t["boxes"] = b[keep]
            t["labels"] = target["labels"][keep]
            if target.get("masks") is not None:
                t["masks"] = target["masks"][keep][:, top:top + h,
                                                   left:left + w]
        elif target.get("masks") is not None:
            t["masks"] = target["masks"][:, top:top + h, left:left + w]
        target = t
    return img, img_strong, target


class DATrainTransform:
    """Weak geometric pipeline applied identically to weak+strong views."""

    def __init__(self, scales, max_size, scales2_resize, scales2_crop,
                 hflip_prob=0.5):
        self.scales = list(scales)
        self.max_size = max_size
        self.scales2_resize = list(scales2_resize)
        self.scales2_crop = tuple(scales2_crop)
        self.hflip_prob = hflip_prob

    def __call__(self, img, img_strong, target, rng: random.Random):
        if rng.random() < self.hflip_prob:
            img, img_strong, target = _hflip_triple(img, img_strong, target)
        if rng.random() < 0.5:
            size = rng.choice(self.scales)
            img, img_strong, target = _resize_triple(
                img, img_strong, target, size, self.max_size)
        else:
            size = rng.choice(self.scales2_resize)
            img, img_strong, target = _resize_triple(
                img, img_strong, target, size, None)
            # RandomSizeCrop(min, max)
            w, h = _wh(img)
            cw = rng.randint(self.scales2_crop[0],
                             min(w, self.scales2_crop[1]))
            ch = rng.randint(self.scales2_crop[0],
                             min(h, self.scales2_crop[1]))
            cw, ch = min(cw, w), min(ch, h)
            top = rng.randint(0, h - ch)
            left = rng.randint(0, w - cw)
            img, img_strong, target = _crop_triple(
                img, img_strong, target, (top, left, ch, cw))
            size = rng.choice(self.scales)
            img, img_strong, target = _resize_triple(
                img, img_strong, target, size, self.max_size)
        return img, img_strong, target


class SingleDomainTrainTransform:
    """The DA weak-geometry chain on one (img, target) pair; with
    strong_aug, one of {LightingNoise, AdjustBrightness(2),
    AdjustContrast(2)} by RandomSelectMulti."""

    def __init__(self, scales, max_size, scales2_resize, scales2_crop,
                 strong_aug=False, hflip_prob=0.5):
        self._geo = DATrainTransform(scales, max_size, scales2_resize,
                                     scales2_crop, hflip_prob)
        self.strong_aug = strong_aug

    def __call__(self, img, target, rng: random.Random):
        img, _, target = self._geo(img, None, target, rng)
        if self.strong_aug:
            from .strong_aug import (
                adjust_brightness,
                adjust_contrast,
                lighting_noise,
                random_select_multi,
            )

            op = random_select_multi(
                [
                    lambda im: lighting_noise(im, rng),
                    lambda im: adjust_brightness(im, rng.uniform(0.5, 2.0)),
                    lambda im: adjust_contrast(im, rng.uniform(0.5, 2.0)),
                ],
                rng,
            )
            img = op(img)
        return img, target


class EvalTransform:
    def __init__(self, size, max_size):
        self.size = size
        self.max_size = max_size

    def __call__(self, img, target):
        img, _, target = _resize_triple(img, None, target, self.size,
                                        self.max_size)
        return img, target


def finalize_example(
    img: np.ndarray,
    target: Optional[Dict],
    canvas_hw: Tuple[int, int],
    max_boxes: int,
    mask_stride: int = 4,
) -> Dict[str, np.ndarray]:
    """Normalize + pad to the static canvas; boxes -> cxcywh normalized by
    the real (unpadded) size, padded to max_boxes. An image larger than the
    canvas is first scaled to fit, in float32 (`native.resize_normalize_pad`).
    A target's `masks` leave as `masks` [max_boxes, ceil(H / s), ceil(W /
    s)] f16 with s = `mask_stride`: each mask's occupied region padded to a
    multiple of s with background and block-averaged (soft targets in
    [0, 1]; s = 1 keeps the binary masks at the canvas)."""
    H, W = canvas_hw
    u8 = np.asarray(img, np.uint8)
    h, w = u8.shape[0], u8.shape[1]
    if h > H or w > W:  # canvas must fit the largest aug size
        scale = min(H / h, W / w)
        nh, nw = int(h * scale), int(w * scale)
        if target is not None and len(target.get("boxes", [])):
            b = target["boxes"].copy()
            b *= scale
            target = dict(target, boxes=b)
        if target is not None and target.get("masks") is not None:
            target = dict(target,
                          masks=_resize_masks(target["masks"], nh, nw))
        h, w = nh, nw

    canvas = native.resize_normalize_pad(u8, (h, w), (H, W), IMAGENET_MEAN,
                                         IMAGENET_STD)
    pad_mask = np.ones((H, W), bool)
    pad_mask[:h, :w] = False

    out = {
        "image": canvas,
        "pad_mask": pad_mask,
        "real_size": np.array([h, w], np.int64),
    }
    if target is not None:
        boxes = np.zeros((max_boxes, 4), np.float32)
        labels = np.zeros((max_boxes,), np.int32)
        valid = np.zeros((max_boxes,), bool)
        tb = target.get("boxes", np.zeros((0, 4), np.float32))
        tl = target.get("labels", np.zeros((0,), np.int64))
        n = min(len(tb), max_boxes)
        if n:
            b = tb[:n].astype(np.float32)
            cxcywh = np.stack(
                [
                    (b[:, 0] + b[:, 2]) / 2.0 / w,
                    (b[:, 1] + b[:, 3]) / 2.0 / h,
                    (b[:, 2] - b[:, 0]) / w,
                    (b[:, 3] - b[:, 1]) / h,
                ],
                axis=1,
            )
            boxes[:n] = cxcywh
            labels[:n] = tl[:n]
            valid[:n] = True
        out.update(boxes=boxes, labels=labels, valid=valid)
        if target.get("masks") is not None:
            out["masks"] = _mask_targets(target["masks"], n, (h, w),
                                         canvas_hw, max_boxes, mask_stride)
        if "image_id" in target:
            out["image_id"] = np.int64(target["image_id"])
        if "orig_size" in target:
            out["orig_size"] = np.asarray(target["orig_size"], np.int64)
    return out


def _mask_targets(tm: np.ndarray, n: int, hw: Tuple[int, int],
                  canvas_hw: Tuple[int, int], max_boxes: int,
                  mask_stride: int) -> np.ndarray:
    """The first n masks [n, h, w] as f16 targets at the stride grid of the
    canvas (datr_tpu/data/transforms.py:282-304)."""
    H, W = canvas_hw
    h, w = hw
    s = max(1, int(mask_stride))
    if s == 1:
        mk = np.zeros((max_boxes, H, W), np.float16)
        if n and len(tm):
            mk[:n, :h, :w] = tm[:n]
        return mk
    mk = np.zeros((max_boxes, -(-H // s), -(-W // s)), np.float16)
    if n and len(tm):
        ph, pw = -(-h // s) * s, -(-w // s) * s
        buf = np.zeros((n, ph, pw), np.uint8)
        buf[:, :h, :w] = tm[:n]
        mk[:n, :ph // s, :pw // s] = buf.reshape(
            n, ph // s, s, pw // s, s).mean((2, 4), dtype=np.float32)
    return mk
