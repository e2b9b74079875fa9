"""PNG without PIL: decode to RGB as PIL's `.convert("RGB")` does, and a
small encoder for request bodies and tests.

The card's machine has no PIL, and Cityscapes / Foggy Cityscapes frames are
8-bit RGB PNGs. The chunks are parsed here, the IDAT stream is inflated by
the standard library's zlib (which releases the GIL), and the five scanline
filters are undone by a host routine of the port (csrc/png_unfilter.cpp,
built with g++ at first use): Sub, Average and Paeth are recurrences along
each row. Colour types 0, 2, 3, 4 and 6 at bit depth 8, non-interlaced, are
read; any other PNG raises NotImplementedError.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Optional

import numpy as np

from ..native import host_library

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel of each colour type: gray, RGB, palette, gray + alpha,
# RGB + alpha
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
FILTERS = (0, 1, 2, 3, 4)  # None, Sub, Up, Average, Paeth
_UNPORTED = ("is not read by the port's PNG decoder (8-bit, non-interlaced "
             "colour types 0, 2, 3, 4, 6 only; ROADMAP §A, image formats)")
_SIG = {"png_unfilter": ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                          ctypes.c_int, ctypes.c_void_p], ctypes.c_int)}


def _chunks(data: bytes):
    """(type, body) of each chunk up to IEND, CRCs checked."""
    pos = len(SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError("PNG truncated before IEND")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + n
        if end > len(data):
            raise ValueError(f"PNG chunk {kind!r} truncated")
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:end])
        if zlib.crc32(body, zlib.crc32(kind)) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end


def decode_png_rgb(data: bytes) -> Optional[np.ndarray]:
    """PNG bytes -> uint8 [H, W, 3] RGB, equal to PIL's
    `Image.open(...).convert("RGB")`: alpha is dropped, gray replicated, a
    palette looked up. Returns None where `data` has no PNG signature;
    raises ValueError on a corrupt PNG and NotImplementedError on a PNG
    outside the supported kinds."""
    data = bytes(data)
    if not data.startswith(SIGNATURE):
        return None
    header = palette = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind != b"IEND" and kind[:1].isupper():
            raise ValueError(f"unknown critical PNG chunk {kind!r}")
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in CHANNELS or interlace:
        raise NotImplementedError(
            f"PNG of bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace} {_UNPORTED}")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    c = CHANNELS[ctype]
    rowbytes = w * c
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from e
    if len(raw) < h * (rowbytes + 1):
        raise ValueError(f"PNG image data truncated: {len(raw)} bytes for "
                         f"{h} rows of {rowbytes + 1}")
    src = np.frombuffer(raw, np.uint8)
    pix = np.empty((h, w, c), np.uint8)
    lib = host_library("png_unfilter", _SIG)
    bad = lib.png_unfilter(src.ctypes.data, h, rowbytes, c, pix.ctypes.data)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has an unknown filter type")
    if ctype == 3:
        # entries past the PLTE chunk read as black, as in PIL
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[pix[..., 0]]
    if ctype in (0, 4):
        return np.repeat(pix[..., :1], 3, axis=2)
    return np.ascontiguousarray(pix[..., :3])


def _paeth(a, b, c):
    a, b, c = (x.astype(np.int16) for x in (a, b, c))
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(pixels: np.ndarray, palette: Optional[np.ndarray] = None,
               filters=FILTERS) -> bytes:
    """uint8 [H, W] or [H, W, C] (C = 1 gray, 2 gray + alpha, 3 RGB, 4 RGB +
    alpha; [H, W] with `palette` [N, 3]: palette indices) -> PNG bytes, row
    y filtered with filters[y % len(filters)], so a decoder meets each
    filter type. The filters are computed from the unfiltered rows, so the
    encoder vectorizes in numpy."""
    px = np.asarray(pixels, np.uint8)
    if px.ndim == 2:
        px = px[..., None]
    h, w, c = px.shape
    if palette is not None:
        if c != 1:
            raise ValueError("palette indices take an [H, W] array")
        ctype = 3
    else:
        ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = px.reshape(h, w * c).astype(np.int16)
    left = np.zeros_like(rows)
    left[:, c:] = rows[:, :-c]
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    upleft = np.zeros_like(rows)
    upleft[1:, c:] = rows[:-1, :-c]
    pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1,
            4: _paeth(left, up, upleft)}
    kinds = np.asarray(filters, np.uint8)[np.arange(h) % len(filters)]
    out = np.empty((h, w * c + 1), np.uint8)
    out[:, 0] = kinds
    for k in set(kinds.tolist()):
        sel = kinds == k
        p = pred[k] if k == 0 else pred[k][sel]
        out[sel, 1:] = ((rows[sel] - p) & 0xFF).astype(np.uint8)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(body, zlib.crc32(kind))))

    parts = [SIGNATURE, chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                                   ctype, 0, 0, 0))]
    if palette is not None:
        parts.append(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    parts.append(chunk(b"IDAT", zlib.compress(out.tobytes(), 1)))  # fast
    parts.append(chunk(b"IEND", b""))
    return b"".join(parts)
