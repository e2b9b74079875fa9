"""The serving path's host and post-processing steps in plain numpy /
PyTorch: the resize rule (short side, long-side cap, fit to the canvas),
the bilinear resize kept in uint8, the canvas, the normalization and pad
mask, and the flat top-k over queries x classes."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .model import box_cxcywh_to_xyxy

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def resized_hw(h: int, w: int, short: int, max_size: int,
               canvas_hw: Tuple[int, int]) -> Tuple[int, int]:
    """The resized extent: short side `short`, the long side capped at
    `max_size`, then scaled down to fit the canvas."""
    lo, hi = float(min(w, h)), float(max(w, h))
    size = short
    if hi / lo * size > max_size:
        size = int(round(max_size * lo / hi))
    if (w <= h and w == size) or (h <= w and h == size):
        oh, ow = h, w
    elif w < h:
        ow, oh = size, int(size * h / w)
    else:
        oh, ow = size, int(size * w / h)
    H, W = canvas_hw
    if oh > H or ow > W:
        s = min(H / oh, W / ow)
        oh, ow = int(oh * s), int(ow * s)
    return oh, ow


def resize_u8(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Bilinear (half-pixel centres, edge-clamped) resize kept in uint8:
    every weight and sum in float32, one rounding per operation, the value
    rounded half up."""
    sh, sw = img.shape[:2]
    f32 = np.float32
    sy, sx = f32(sh) / f32(oh), f32(sw) / f32(ow)
    fy = (np.arange(oh, dtype=f32) + f32(0.5)) * sy - f32(0.5)
    fx = (np.arange(ow, dtype=f32) + f32(0.5)) * sx - f32(0.5)
    y0, x0 = np.floor(fy).astype(np.int64), np.floor(fx).astype(np.int64)
    wy = (fy - y0.astype(f32))[:, None, None]
    wx = (fx - x0.astype(f32))[None, :, None]
    r0, r1 = np.clip(y0, 0, sh - 1), np.clip(y0 + 1, 0, sh - 1)
    c0, c1 = np.clip(x0, 0, sw - 1), np.clip(x0 + 1, 0, sw - 1)
    one = f32(1)
    w00, w01 = (one - wx) * (one - wy), wx * (one - wy)
    w10, w11 = (one - wx) * wy, wx * wy
    src = img.astype(f32)
    v = (w00 * src[r0][:, c0] + w01 * src[r0][:, c1]
         + w10 * src[r1][:, c0] + w11 * src[r1][:, c1])
    return (v + f32(0.5)).astype(np.uint8)


def canvas_input(img: np.ndarray, short: int, max_size: int,
                 canvas_hw: Tuple[int, int], device):
    """One frame -> (normalized f32 [1, H, W, 3] with the pad zeroed, pad
    mask [1, H, W], real (h, w))."""
    oh, ow = resized_hw(img.shape[0], img.shape[1], short, max_size,
                        canvas_hw)
    H, W = canvas_hw
    canvas = np.zeros((H, W, 3), np.uint8)
    canvas[:oh, :ow] = resize_u8(img, oh, ow)
    x = torch.from_numpy(canvas).to(device).float()
    x = (x / 255.0 - torch.from_numpy(MEAN).to(device)) / torch.from_numpy(
        STD).to(device)
    pad = torch.ones((H, W), dtype=torch.bool, device=device)
    pad[:oh, :ow] = False
    return x.masked_fill(pad[..., None], 0.0)[None], pad[None], (oh, ow)


def detections(logits: torch.Tensor, boxes: torch.Tensor, orig_hw,
               num_select: int):
    """One image's flat top-k: (scores [k], labels [k], xyxy boxes in
    original pixels [k, 4], clipped), and every candidate's score [Q, K]
    and box [Q, 4] in the same pixels."""
    Q, K = logits.shape
    prob = logits.float().sigmoid()
    top = torch.sort(prob.reshape(-1), descending=True,
                     stable=True).indices[:num_select]
    h0, w0 = orig_hw
    scale = torch.tensor([w0, h0, w0, h0], dtype=torch.float32,
                         device=logits.device)
    b = box_cxcywh_to_xyxy(boxes.float()) * scale
    b[:, 0::2] = b[:, 0::2].clamp(0, w0)
    b[:, 1::2] = b[:, 1::2].clamp(0, h0)
    return (prob.reshape(-1)[top], top % K, b[top // K], prob, b)
