"""PIL's image operations in numpy, on uint8 [H, W, 3] RGB arrays.

datr_tpu's augmentations call PIL (`Image.resize(BILINEAR)`, `transpose`,
`crop`, `convert("L")` / `convert("HSV")`, `ImageEnhance`, `GaussianBlur`);
the card's machine has no PIL. Each function here computes what the PIL call
computes, with PIL's own fixed-point and single-precision arithmetic, so the
two pipelines give the same pixels (tests/test_torch_port_data.py holds each
against Pillow). No per-pixel Python loop: loops run over filter taps and
blur passes only.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_PRECISION_BITS = 32 - 8 - 2  # Resample.c
_BLUR_PASSES = 3  # ImageFilter.GaussianBlur's box passes per axis


def _resample_coeffs(in_size: int, out_size: int):
    """Resample.c precompute_coeffs + normalize_coeffs_8bpc for the
    bilinear (triangle) filter over the whole axis: (first tap [out],
    integer coefficients [out, ksize] with zeros past each row's taps)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the triangle's support 1, widened on a downscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    ss = 1.0 / filterscale
    k = np.zeros((out_size, ksize))
    ww = np.zeros(out_size)
    for x in range(ksize):  # the taps in C's order, so `ww` sums alike
        w = np.maximum(1.0 - np.abs((x + xmin - center + 0.5) * ss), 0.0)
        w = np.where(x < xmax, w, 0.0)
        k[:, x] = w
        ww += w
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None],
                 k)
    # (int)(0.5 + k * 2^22): the coefficients are never negative here
    kk = (0.5 + k * (1 << _PRECISION_BITS)).astype(np.int64)
    return xmin, kk


def _resample_axis0(src: np.ndarray, out_size: int) -> np.ndarray:
    """One pass of PIL's 8-bit resample along axis 0 of uint8 `src`:
    int32 sums from 2^21 (rounding), `>> 22`, clipped to uint8, as in PIL
    (255 times the coefficients' sum stays below 2^31)."""
    xmin, kk = _resample_coeffs(src.shape[0], out_size)
    src = np.ascontiguousarray(src)
    last = src.shape[0] - 1
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int32)
    shape = (out_size,) + (1,) * (src.ndim - 1)
    kk = kk.astype(np.int32)
    for x in range(kk.shape[1]):
        rows = np.minimum(xmin + x, last)
        acc += src[rows].astype(np.int32) * kk[:, x].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """`Image.resize((ow, oh), Image.BILINEAR)`: a horizontal pass, then a
    vertical pass, each skipped where its axis keeps its size; on a
    downscale the triangle widens with the scale (PIL's antialiasing)."""
    ow, oh = size
    h, w = img.shape[:2]
    out = np.ascontiguousarray(img)
    if ow != w:
        out = np.ascontiguousarray(
            _resample_axis0(out.swapaxes(0, 1), ow).swapaxes(0, 1))
    if oh != h:
        out = _resample_axis0(out, oh)
    return out if out is not img else img.copy()


def hflip(img: np.ndarray) -> np.ndarray:
    """`img.transpose(Image.FLIP_LEFT_RIGHT)`."""
    return np.ascontiguousarray(img[:, ::-1])


def crop(img: np.ndarray, box: Tuple[int, int, int, int]) -> np.ndarray:
    """`img.crop((left, top, right, bottom))`: pixels outside the image
    are zero, as in PIL."""
    left, top, right, bottom = box
    out = np.zeros((bottom - top, right - left) + img.shape[2:], img.dtype)
    h, w = img.shape[:2]
    y0, y1 = max(top, 0), min(bottom, h)
    x0, x1 = max(left, 0), min(right, w)
    if y1 > y0 and x1 > x0:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = img[y0:y1, x0:x1]
    return out


def to_gray_l(img: np.ndarray) -> np.ndarray:
    """`convert("L")`: [H, W] uint8, ITU-R 601-2 luma in 16-bit fixed
    point (Convert.c L24)."""
    c = img.astype(np.int32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def gray_to_rgb(gray: np.ndarray) -> np.ndarray:
    """`convert("RGB")` of an L image."""
    return np.repeat(gray[..., None], 3, axis=-1)


def blend(im1: np.ndarray, im2: np.ndarray, alpha: float) -> np.ndarray:
    """`Image.blend(im1, im2, alpha)` (Blend.c): in1 + alpha (in2 - in1) in
    float32, truncated to uint8; outside [0, 1] the result is clipped
    first."""
    a = np.float32(alpha)
    f1 = im1.astype(np.float32)
    out = f1 + a * (im2.astype(np.float32) - f1)
    if 0.0 <= a <= 1.0:
        return out.astype(np.uint8)
    return np.clip(out, 0.0, 255.0).astype(np.uint8)


def brightness(img: np.ndarray, factor: float) -> np.ndarray:
    """`ImageEnhance.Brightness(img).enhance(factor)`: a blend with black."""
    return blend(np.zeros_like(img), img, factor)


def contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """`ImageEnhance.Contrast(img).enhance(factor)`: a blend with the
    constant gray of the L image's rounded mean (ImageStat's histogram
    mean)."""
    gray = to_gray_l(img)
    mean = float(int(gray.sum(dtype=np.int64))) / gray.size
    degenerate = np.full_like(img, int(mean + 0.5))
    return blend(degenerate, img, factor)


def color(img: np.ndarray, factor: float) -> np.ndarray:
    """`ImageEnhance.Color(img).enhance(factor)`: a blend with the image's
    gray version."""
    return blend(gray_to_rgb(to_gray_l(img)), img, factor)


def _clip8(v: np.ndarray) -> np.ndarray:
    return np.clip(v, 0, 255).astype(np.uint8)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """`convert("HSV")` (Convert.c rgb2hsv_row): float32 ratios, the hue's
    offsets and wrap in double, each channel truncated to uint8."""
    c = img.astype(np.int32)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    maxc = np.maximum(r, np.maximum(g, b))
    minc = np.minimum(r, np.minimum(g, b))
    grey = maxc == minc
    cr = np.where(grey, 1, maxc - minc).astype(np.float32)
    s = cr / np.where(maxc == 0, 1, maxc).astype(np.float32)
    rc = (maxc - r).astype(np.float32) / cr
    gc = (maxc - g).astype(np.float32) / cr
    bc = (maxc - b).astype(np.float32) / cr
    h_r = (bc - gc).astype(np.float64)
    # `2.0 + rc - bc` is a double expression stored in a float
    h_g = (2.0 + rc.astype(np.float64) - bc).astype(np.float32)
    h_b = (4.0 + gc.astype(np.float64) - rc).astype(np.float32)
    h = np.where(r == maxc, h_r, np.where(g == maxc, h_g, h_b))
    h = np.fmod(h.astype(np.float32).astype(np.float64) / 6.0 + 1.0,
                1.0).astype(np.float32)
    uh = _clip8((h.astype(np.float64) * 255.0).astype(np.int64))
    us = _clip8((s.astype(np.float64) * 255.0).astype(np.int64))
    out = np.stack([np.where(grey, 0, uh), np.where(grey, 0, us),
                    maxc.astype(np.uint8)], -1)
    return out.astype(np.uint8)


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """C's round() on non-negative doubles."""
    fl = np.floor(x)
    return np.where(x - fl >= 0.5, fl + 1.0, fl).astype(np.int64)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """`Image.merge("HSV", ...).convert("RGB")` (Convert.c hsv2rgb)."""
    h = hsv[..., 0].astype(np.float64)
    s = hsv[..., 1]
    v8 = hsv[..., 2]
    v = v8.astype(np.float64)
    h6 = h * 6.0 / 255.0
    i = np.floor(h6).astype(np.int64)
    f = (h6 - i).astype(np.float32)
    fs = (s.astype(np.float64) / 255.0).astype(np.float32)
    p = _clip8(_round_half_away(v * (1.0 - fs.astype(np.float64))))
    q = _clip8(_round_half_away(v * (1.0 - (fs * f).astype(np.float64))))
    t = _clip8(_round_half_away(
        v * (1.0 - fs.astype(np.float64) * (1.0 - f.astype(np.float64)))))
    # Convert.c's switch on the sector: which of (v, t, p, q) each channel
    # takes
    order = np.array([(0, 1, 2), (3, 0, 2), (2, 0, 1), (2, 3, 0), (1, 2, 0),
                      (0, 2, 3)])
    cand = np.stack([v8, t, p, q], -1)
    out = np.take_along_axis(cand, order[i % 6], axis=-1)
    grey = s == 0
    out[grey] = v8[grey][:, None]
    return out


def _gaussian_blur_radius(radius: np.float32) -> np.float32:
    """BoxBlur.c _gaussian_blur_radius: the extended box's radius for one
    of the passes, in float32 with the double sqrt and floor."""
    f32 = np.float32
    sigma2 = f32(f32(radius * radius) / f32(_BLUR_PASSES))
    big_l = f32(math.sqrt(12.0 * float(sigma2) + 1.0))
    ll = f32(math.floor((float(big_l) - 1.0) / 2.0))
    a = f32(f32(f32(2) * ll + f32(1)) * f32(ll * f32(ll + f32(1))
                                            - f32(3) * sigma2))
    a = f32(a / f32(f32(6) * f32(sigma2 - f32(ll + f32(1)) * f32(ll + f32(1)))))
    return f32(ll + a)


def _box_blur_axis0(src: np.ndarray, radius: np.float32) -> np.ndarray:
    """BoxBlur.c ImagingLineBoxBlur along axis 0: the clamped window of
    2r + 1 pixels times ww plus the two next ones times fw, in 24-bit fixed
    point, uint32 as in PIL (the sum stays below 2^32)."""
    r = int(radius)
    ww = int(np.float32(1 << 24) / np.float32(radius * np.float32(2)
                                              + np.float32(1)))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    n = src.shape[0]
    idx = np.clip(np.arange(-r - 1, n + r + 1), 0, n - 1)
    ext = src[idx].astype(np.uint32)  # [n + 2r + 2, ...]
    # output x: window ext[x + 1 .. x + 2r + 1], far pixels ext[x] and
    # ext[x + 2r + 2]
    if r <= 8:
        acc = ext[1:1 + n].copy()
        for j in range(2, 2 * r + 2):
            acc += ext[j:j + n]
    else:
        csum = np.cumsum(ext, axis=0, dtype=np.uint32)
        acc = csum[2 * r + 1:2 * r + 1 + n] - csum[:n]
    acc *= np.uint32(ww)
    far = ext[:n] + ext[2 * r + 2:2 * r + 2 + n]
    far *= np.uint32(fw)
    acc += far
    acc += np.uint32(1 << 23)
    acc >>= np.uint32(24)
    return acc.astype(np.uint8)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """`img.filter(ImageFilter.GaussianBlur(radius=sigma))`: three extended
    box blurs along x, then three along y."""
    if sigma == 0:
        return img.copy()
    radius = _gaussian_blur_radius(np.float32(sigma))
    out = np.ascontiguousarray(img)
    if radius != 0:
        t = np.ascontiguousarray(out.swapaxes(0, 1))
        for _ in range(_BLUR_PASSES):
            t = _box_blur_axis0(t, radius)
        out = t.swapaxes(0, 1)
        for _ in range(_BLUR_PASSES):
            out = _box_blur_axis0(out, radius)
    return np.ascontiguousarray(out)


# ---------------------------------------------------------------- polygons

def _roundf(x) -> np.ndarray:
    """C's roundf of float32 values: halves away from zero, exactly."""
    x = np.asarray(x, np.float64)
    return np.where(x >= 0, np.floor(x + 0.5), -np.floor(-x + 0.5))


def _round_up(x: np.ndarray) -> np.ndarray:
    """Draw.c ROUND_UP of float32 x: floor(x + 0.5f) with the sum taken in
    float32 where x >= 0, in double below."""
    pos = np.floor((x + np.float32(0.5)).astype(np.float64))
    neg = -np.floor(np.abs(x.astype(np.float64)) + 0.5)
    return np.where(x >= 0, pos, neg).astype(np.int64)


def _round_down(x: np.ndarray) -> np.ndarray:
    """Draw.c ROUND_DOWN: ceil(x - 0.5f), the same precisions."""
    pos = np.ceil((x - np.float32(0.5)).astype(np.float64))
    neg = -np.ceil(np.abs(x.astype(np.float64)) - 0.5)
    return np.where(x >= 0, pos, neg).astype(np.int64)


def _polygon_edges(xy: np.ndarray):
    """ImagingDrawPolygon's edge list of integer vertices [n, 2]: a
    horizontal edge that continues the previous one in the same x
    direction widens the previous edge instead (its xmin / xmax); the
    closing edge is added unless the last vertex is the first. Rows of
    (x0, y0, x1, y1, xmin, xmax)."""
    edges = []
    for i in range(len(xy) - 1):
        (x0, y0), (x1, y1) = xy[i], xy[i + 1]
        if y0 == y1 and i != 0 and y0 == xy[i - 1][1]:
            px = xy[i - 1][0]
            if x1 > x0 > px:
                edges[-1][5] = x1
                continue
            if x1 < x0 < px:
                edges[-1][4] = x1
                continue
        edges.append([x0, y0, x1, y1, min(x0, x1), max(x0, x1)])
    if tuple(xy[-1]) != tuple(xy[0]):
        (x0, y0), (x1, y1) = xy[-1], xy[0]
        edges.append([x0, y0, x1, y1, min(x0, x1), max(x0, x1)])
    return np.asarray(edges, np.int64).reshape(-1, 6)


def polygon_fill(coords, h: int, w: int) -> np.ndarray:
    """`ImageDraw.Draw(Image.new("L", (w, h))).polygon(coords, fill=1)` as
    Pillow 12 draws it (Draw.c ImagingDrawPolygon -> polygon_generic):
    uint8 [h, w] of 0 / 1. The vertices are truncated to integers; each
    horizontal edge is a span of its own; every other row between the
    polygon's top and bottom gets the edges' float32 crossings, a crossing
    doubled where an edge ends above the last row, and a crossing that
    sits at a corner where two edges of the same slope sign start or end
    on this row is moved one pixel past the neighbouring row's crossings
    of both edges (Pillow's "connect discontiguous corners"); the sorted
    crossings pair up into spans [ROUND_UP(a), ROUND_DOWN(b)]. Vectorized
    over rows and edges; only the corner rows loop in Python."""
    out = np.zeros((h, w), np.uint8)
    xy = np.trunc(np.asarray(coords, np.float64)).astype(np.int64)
    xy = xy.reshape(-1, 2)
    if len(xy) == 0:
        return out
    e = _polygon_edges(xy)
    if len(e) == 0:
        return out
    x0, y0, x1, y1, xmin, xmax = e.T
    ymin, ymax = np.minimum(y0, y1), np.maximum(y0, y1)
    lo = max(min(h - 1, int(ymin.min())), 0)
    hi = min(max(0, int(ymax.max())), h)
    spans = []  # (row, first x, last x)
    flat = ymin == ymax
    spans += [(int(y), int(a), int(b))
              for y, a, b in zip(ymin[flat], xmin[flat], xmax[flat])]
    keep = ~flat
    x0, y0, ymin, ymax = x0[keep], y0[keep], ymin[keep], ymax[keep]
    dx = ((x1[keep] - x0).astype(np.float32)
          / (y1[keep] - y0).astype(np.float32))
    x0f = x0.astype(np.float32)

    def line(k, y):  # (y - y0) * dx + x0 in float32, as the C does
        return np.float32(y - y0[k]) * dx[k] + x0f[k]

    if len(dx):
        rows = np.arange(lo, hi + 1)
        X = (rows[:, None] - y0[None]).astype(np.float32) * dx + x0f
        active = (rows[:, None] >= ymin) & (rows[:, None] <= ymax)
        dup = active & (rows[:, None] == ymax) & (rows[:, None] < hi)
        lines = X.copy()  # the edges' own crossings, before any move
        # corners: an edge's own end row, the other edge earlier in the
        # table ending (or starting) on the same row at the same rounded x
        for r, i in zip(*np.nonzero(
                active & ~dup & (dx != 0)
                & ((rows[:, None] == ymin) | (rows[:, None] == ymax)))):
            y, x = int(rows[r]), X[r, i]
            ks = np.arange(i)
            join = (_roundf(lines[r, :i]) == _roundf(x)) & (
                ((y == ymin[i]) & (ymin[:i] == y))
                | ((y == ymax[i]) & (ymax[:i] == y)))
            opp = (dx[:i] <= 0) if dx[i] > 0 else (dx[:i] >= 0)
            off = -1 if y == ymax[i] else 1
            near = (ymin[:i] <= y + off) & (y + off <= ymax[:i])
            stop = join & np.where(opp, dx[:i] != 0, near)
            if not stop.any():
                continue
            k = int(ks[stop][0])
            if opp[k]:
                continue
            a, b = line(i, y + off), line(k, y + off)
            if x > a + 1 and x > b + 1:
                X[r, i] = np.float32(_roundf(max(a, b)) + 1)
            elif x < a - 1 and x < b - 1:
                X[r, i] = np.float32(_roundf(min(a, b)) - 1)
        n = active.sum(1) + dup.sum(1)
        vals = np.concatenate([np.where(active, X, np.inf),
                               np.where(dup, X, np.inf)], 1)
        vals.sort(1)
        for m in range(0, vals.shape[1] - 1, 2):
            ok = m + 1 < n
            if not ok.any():
                break
            a = _round_up(np.where(ok, vals[:, m], 0).astype(np.float32))
            b = _round_down(np.where(ok, vals[:, m + 1], 0).astype(
                np.float32))
            ok &= b >= a
            spans += [(int(y), int(s), int(t))
                      for y, s, t in zip(rows[ok], a[ok], b[ok])]
    for y, a, b in spans:  # hline8: clipped to the image
        if 0 <= y < h and a < w and b >= 0:
            a, b = max(a, 0), min(b, w - 1)
            if a <= b:
                out[y, a:b + 1] = 1
    return out
