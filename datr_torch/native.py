"""Host image preprocessing: the serving resize (own copy of the numpy form
of datr_tpu/native/__init__.py:235-275, which carries the native C++
kernel's exact sampling and rounding) and the training / eval canvas step
(`resize_normalize_pad`)."""

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


def resize_normalize_pad(img_u8: np.ndarray, out_hw, canvas_hw,
                         mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """Bilinear resize (align_corners=False) + ImageNet normalize + zero pad
    into a float32 [H, W, 3] canvas: the arithmetic of datr_tpu's native
    kernel (datr_tpu/native/image_ops.cpp resize_normalize_pad, whose numpy
    oracle is datr_tpu/native/__init__.py:112-138), every operation in
    float32 and in its order, so the canvases are bitwise equal. An
    unscaled image skips the sampling: its weights are exactly 1 and 0."""
    f32 = np.float32
    sh, sw = img_u8.shape[:2]
    dh, dw = out_hw
    H, W = canvas_hw
    src = img_u8.astype(f32)
    if (dh, dw) == (sh, sw):
        v = src
    else:
        def axis(n_out, n_in):
            scale = f32(n_in) / f32(n_out)
            pos = (np.arange(n_out, dtype=f32) + f32(0.5)) * scale - f32(0.5)
            i0 = np.floor(pos).astype(np.int64)
            frac = pos - i0.astype(f32)
            return (frac, np.clip(i0, 0, n_in - 1),
                    np.clip(i0 + 1, 0, n_in - 1))

        wy, y0, y1 = axis(dh, sh)
        wx, x0, x1 = axis(dw, sw)
        wy, wx = wy[:, None, None], wx[None, :, None]
        one = f32(1)
        r0, r1 = src[y0], src[y1]
        v = ((one - wx) * (one - wy) * r0[:, x0] + wx * (one - wy) * r0[:, x1]
             + (one - wx) * wy * r1[:, x0] + wx * wy * r1[:, x1])
    inv_std = f32(1) / np.asarray(std, f32)
    out = np.zeros((H, W, 3), f32)
    out[:dh, :dw] = (v * (f32(1) / f32(255)) - np.asarray(mean, f32)) * inv_std
    return out
