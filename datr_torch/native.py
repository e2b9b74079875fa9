"""Host preprocessing for serving (own copy of the numpy form of
datr_tpu/native/__init__.py:235-275, which carries the native C++ kernel's
exact sampling and rounding)."""

from __future__ import annotations

import numpy as np


def resize_pad_u8(img_u8: np.ndarray, out_hw, canvas_hw) -> np.ndarray:
    """Bilinear resize (align_corners=False) kept in uint8, zero-padded into
    an [H, W, 3] canvas at the top-left."""
    sh, sw = img_u8.shape[:2]
    dh, dw = out_hw
    H, W = canvas_hw
    ys = (np.arange(dh) + 0.5) * (sh / dh) - 0.5
    xs = (np.arange(dw) + 0.5) * (sw / dw) - 0.5
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    y0c = np.clip(y0, 0, sh - 1)
    y1c = np.clip(y0 + 1, 0, sh - 1)
    x0c = np.clip(x0, 0, sw - 1)
    x1c = np.clip(x0 + 1, 0, sw - 1)
    f = img_u8.astype(np.float32)
    out = (
        f[y0c][:, x0c] * (1 - wy) * (1 - wx)
        + f[y0c][:, x1c] * (1 - wy) * wx
        + f[y1c][:, x0c] * wy * (1 - wx)
        + f[y1c][:, x1c] * wy * wx
    )
    canvas = np.zeros((H, W, 3), np.uint8)
    # u8 = trunc(v + 0.5); v is a convex combination, already in [0, 255]
    canvas[:dh, :dw] = (out + 0.5).astype(np.uint8)
    return canvas
