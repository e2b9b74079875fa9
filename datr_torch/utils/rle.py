"""COCO run-length-encoded masks: encode / decode and mask IoU (the port's
own copy of datr_tpu/utils/rle.py; numpy, outputs bitwise equal).

The COCO RLE format as pycocotools writes it: column-major (Fortran) pixel
order, run lengths alternating background / foreground starting with
background, and the varint + delta string coding of maskApi.c rleFrString /
rleToString. Mask IoU decodes each mask to column-major bits once, packs
them, and counts the AND of each pair through a popcount table.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

_POPCNT = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _counts_to_flat(counts: np.ndarray, size: int) -> np.ndarray:
    """Run-length counts -> flat column-major uint8 pixels of `size`
    (trailing background runs may be omitted in the encoding)."""
    vals = np.zeros((len(counts),), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    if flat.size < size:
        flat = np.concatenate([flat, np.zeros((size - flat.size,), np.uint8)])
    return flat[:size]


# ---------------------------------------------------------------------------
# counts <-> binary mask
# ---------------------------------------------------------------------------

def encode_mask(mask: np.ndarray) -> np.ndarray:
    """[H, W] binary -> run-length counts (column-major, starts with the
    zero-run; pycocotools rleEncode layout)."""
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    if flat.size == 0:
        return np.zeros((0,), np.int64)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).astype(np.int64)
    if flat[0] == 1:  # first run must be background
        counts = np.concatenate([[0], counts])
    return counts


def decode_counts(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    """Run-length counts -> [H, W] bool (column-major runs)."""
    counts = np.asarray(counts, np.int64)
    return _counts_to_flat(counts, h * w).reshape(w, h).T.astype(bool)


def area_of_counts(counts: Sequence[int]) -> int:
    """Foreground pixel count of an RLE."""
    return int(np.asarray(counts, np.int64)[1::2].sum())


# ---------------------------------------------------------------------------
# counts <-> COCO compressed string (maskApi.c rleFrString / rleToString)
# ---------------------------------------------------------------------------

def counts_from_string(s) -> List[int]:
    if isinstance(s, str):
        s = s.encode()
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def string_from_counts(counts: Sequence[int]) -> str:
    counts = [int(c) for c in counts]
    out = bytearray()
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out).decode()


# ---------------------------------------------------------------------------
# IoU
# ---------------------------------------------------------------------------

def _pack(counts_list, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a list of RLEs to bit-packed rows [N, ceil(HW/8)] + areas."""
    n = len(counts_list)
    packed = np.zeros((n, (h * w + 7) // 8), np.uint8)
    areas = np.zeros((n,), np.int64)
    for i, c in enumerate(counts_list):
        c = np.asarray(c, np.int64)
        packed[i] = np.packbits(_counts_to_flat(c, h * w))
        areas[i] = int(c[1::2].sum())
    return packed, areas


def mask_iou(d_counts: Sequence, g_counts: Sequence, iscrowd: np.ndarray,
             h: int, w: int) -> np.ndarray:
    """[D, G] mask IoU with pycocotools crowd semantics (for crowd GT the
    denominator is the detection area). Inputs are RLE counts lists."""
    D, G = len(d_counts), len(g_counts)
    if D == 0 or G == 0:
        return np.zeros((D, G))
    dp, da = _pack(d_counts, h, w)
    gp, ga = _pack(g_counts, h, w)
    iscrowd = np.asarray(iscrowd, bool)
    iou = np.zeros((D, G))
    # chunk over detections to bound the [chunk, G, HW/8] AND buffer
    step = max(1, int(4e7 // max(gp.shape[0] * gp.shape[1], 1)))
    for s in range(0, D, step):
        e = min(D, s + step)
        # uint8 LUT + int64-accumulated sum: the LUT result stays the same
        # size as the AND buffer the chunking was sized to bound (an int64
        # LUT would transiently allocate 8x that)
        inter = _POPCNT[dp[s:e, None, :] & gp[None, :, :]].sum(
            -1, dtype=np.int64
        )
        union = np.where(iscrowd[None, :], da[s:e, None],
                         da[s:e, None] + ga[None, :] - inter)
        iou[s:e] = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    return iou


def masks_to_rles(masks: np.ndarray) -> List[np.ndarray]:
    """[N, H, W] binary -> list of counts."""
    return [encode_mask(m) for m in np.asarray(masks)]
