"""PNG without PIL: decode to RGB as PIL's `.convert("RGB")` does, and a
small encoder for request bodies and tests.

Every PNG that PIL reads is read here: colour types 0 (gray), 2 (RGB), 3
(palette), 4 (gray + alpha) and 6 (RGB + alpha) at each bit depth the PNG
specification allows them (1, 2, 4, 8, 16 for gray; 1, 2, 4, 8 for a
palette; 8 and 16 for the others), plain or Adam7-interlaced. The chunks
are parsed here, the IDAT stream is inflated by the standard library's
zlib (which releases the GIL), and the five scanline filters are undone by
a host routine of the port (csrc/png_unfilter.cpp, built with g++ at first
use): Sub, Average and Paeth are recurrences along each row. An
interlaced image is seven such passes, each unfiltered on its own and
scattered to its pixels. `unfilter_plain` is the numpy form of that
routine, called by tests and chip_smoke.py only.

The samples become RGB by PIL's rules (Pillow 12): gray below 8 bits is
scaled to 0-255 (x 255, x 85, x 17 at 1, 2, 4 bits); 16-bit gray opens as
PIL's mode "I;16" and its conversion to RGB clips each value to 255;
16-bit RGB, RGBA and gray + alpha keep each sample's high byte; a palette
index past the PLTE chunk reads as black. Alpha and tRNS are dropped.
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
# the bit depths each colour type allows (PNG spec, table 11.1)
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
FILTERS = (0, 1, 2, 3, 4)  # None, Sub, Up, Average, Paeth
# Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
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


def _row_bytes(w: int, c: int, depth: int) -> int:
    return (w * c * depth + 7) // 8


def _passes(w: int, h: int, interlace: int):
    """(x0, y0, dx, dy, pass width, pass height) of each non-empty pass."""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:
            yield x0, y0, dx, dy, pw, ph


def unfilter(src: np.ndarray, h: int, rowbytes: int, bpp: int
             ) -> np.ndarray:
    """h filtered rows (1 filter byte + rowbytes bytes each) -> the
    unfiltered uint8 [h, rowbytes], by the C++ routine; `bpp` is the
    filters' pixel step in bytes (1 below 8 bits a pixel)."""
    out = np.empty((h, rowbytes), np.uint8)
    src = np.ascontiguousarray(src, np.uint8)
    lib = host_library("png_unfilter", _SIG)
    bad = lib.png_unfilter(src.ctypes.data, h, rowbytes, bpp,
                           out.ctypes.data)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has an unknown filter type")
    return out


def unfilter_plain(src: np.ndarray, h: int, rowbytes: int, bpp: int
                   ) -> np.ndarray:
    """`unfilter` in numpy, row by row (tests and chip_smoke.py only)."""
    rows = np.asarray(src, np.uint8)[:h * (rowbytes + 1)].reshape(
        h, rowbytes + 1).astype(np.int32)
    out = np.zeros((h, rowbytes + bpp), np.int32)  # bpp zeros on the left
    prev = np.zeros(rowbytes + bpp, np.int32)
    for y in range(h):
        kind, x = rows[y, 0], rows[y, 1:]
        cur = out[y]
        if kind in (0, 2):
            cur[bpp:] = (x + (prev[bpp:] if kind == 2 else 0)) & 0xFF
        elif kind in (1, 3, 4):
            for i in range(bpp, rowbytes + bpp):
                a, b, c = cur[i - bpp], prev[i], prev[i - bpp]
                if kind == 1:
                    p = a
                elif kind == 3:
                    p = (a + b) >> 1
                else:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (x[i - bpp] + p) & 0xFF
        else:
            raise ValueError(f"PNG row {y} has an unknown filter type")
        prev = cur
    return out[:, bpp:].astype(np.uint8)


def _samples(rows: np.ndarray, w: int, c: int, depth: int) -> np.ndarray:
    """Unfiltered rows [h, rowbytes] -> samples [h, w, c] (uint8, or
    uint16 at 16 bits; big-endian, sub-byte samples from the high bits)."""
    h = rows.shape[0]
    if depth == 8:
        return rows.reshape(h, w, c)
    if depth == 16:
        return rows.view(">u2").reshape(h, w, c).astype(np.uint16)
    bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]


def _to_rgb(s: np.ndarray, ctype: int, depth: int,
            palette: Optional[np.ndarray]) -> np.ndarray:
    """Samples -> uint8 [h, w, 3] by PIL's rules (module docstring)."""
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[s[..., 0]]
    if depth == 16:
        s = (np.minimum(s, 255) if ctype == 0 else s >> 8).astype(np.uint8)
    elif depth < 8:
        s = s * np.uint8(255 // ((1 << depth) - 1))
    if ctype in (0, 4):
        return np.repeat(s[..., :1], 3, axis=2)
    return np.ascontiguousarray(s[..., :3])


def decode_png_rgb(data: bytes) -> Optional[np.ndarray]:
    """PNG bytes -> uint8 [H, W, 3] RGB, equal to PIL's
    `Image.open(...).convert("RGB")` (module docstring). Returns None where
    `data` has no PNG signature; raises ValueError on a malformed PNG."""
    data = bytes(data)
    if not data.startswith(SIGNATURE):
        return None
    header = palette = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"PNG IHDR of {len(body)} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3
                                                     ].reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind != b"IEND" and kind[:1].isupper():
            raise ValueError(f"unknown critical PNG chunk {kind!r}")
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, ctype, comp, filt, interlace = header
    if (ctype not in DEPTHS or depth not in DEPTHS[ctype] or comp or filt
            or interlace > 1 or not w or not h):
        raise ValueError(
            f"malformed PNG header: {w}x{h}, bit depth {depth}, colour type "
            f"{ctype}, compression {comp}, filter {filt}, interlace "
            f"{interlace}")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    c = CHANNELS[ctype]
    bpp = max(1, c * depth // 8)
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from e
    passes = list(_passes(w, h, interlace))
    need = sum(ph * (_row_bytes(pw, c, depth) + 1)
               for *_, pw, ph in passes)
    if len(raw) < need:
        raise ValueError(f"PNG image data truncated: {len(raw)} bytes of "
                         f"{need}")
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((h, w, c), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy, pw, ph in passes:
        rb = _row_bytes(pw, c, depth)
        rows = unfilter(src[pos:pos + ph * (rb + 1)], ph, rb, bpp)
        out[y0::dy, x0::dx] = _samples(rows, pw, c, depth)
        pos += ph * (rb + 1)
    return _to_rgb(out, ctype, depth, palette)


def _paeth(a, b, c):
    a, b, c = (x.astype(np.int16) for x in (a, b, c))
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered(rows: np.ndarray, bpp: int, filters) -> np.ndarray:
    """Byte rows [h, n] -> [h, 1 + n], row y filtered with
    filters[y % len(filters)]. The filters are computed from the
    unfiltered rows, so the encoder vectorizes in numpy."""
    h = rows.shape[0]
    rows = rows.astype(np.int16)
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    upleft = np.zeros_like(rows)
    upleft[1:, bpp:] = rows[:-1, :-bpp]
    pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1,
            4: _paeth(left, up, upleft)}
    kinds = np.asarray(filters, np.uint8)[np.arange(h) % len(filters)]
    out = np.empty((h, rows.shape[1] + 1), np.uint8)
    out[:, 0] = kinds
    for k in set(kinds.tolist()):
        sel = kinds == k
        p = pred[k] if k == 0 else pred[k][sel]
        out[sel, 1:] = ((rows[sel] - p) & 0xFF).astype(np.uint8)
    return out


def _packed(px: np.ndarray, depth: int) -> np.ndarray:
    """Samples [h, w, c] -> byte rows [h, rowbytes] at `depth` bits."""
    h, w, c = px.shape
    if depth == 8:
        return px.astype(np.uint8).reshape(h, w * c)
    if depth == 16:
        return px.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    bits = ((px[..., 0, None].astype(np.uint8)
             >> np.arange(depth - 1, -1, -1).astype(np.uint8)) & 1)
    return np.packbits(bits.reshape(h, w * depth), axis=1)


def encode_png(pixels: np.ndarray, palette: Optional[np.ndarray] = None,
               filters=FILTERS, depth: int = 8,
               interlace: bool = False) -> bytes:
    """[H, W] or [H, W, C] samples (C = 1 gray, 2 gray + alpha, 3 RGB, 4
    RGB + alpha; [H, W] with `palette` [N, 3]: palette indices) -> PNG
    bytes at bit depth `depth` (uint8 samples below 16 bits, each below
    2**depth; uint16 at 16), Adam7-interlaced with `interlace`. Row y of
    each pass is filtered with filters[y % len(filters)], so a decoder
    meets each filter type."""
    px = np.asarray(pixels)
    if px.ndim == 2:
        px = px[..., None]
    h, w, c = px.shape
    if palette is not None:
        if c != 1:
            raise ValueError("palette indices take an [H, W] array")
        ctype = 3
    else:
        ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    if depth not in DEPTHS[ctype]:
        raise ValueError(f"colour type {ctype} takes bit depths "
                         f"{DEPTHS[ctype]}, not {depth}")
    if px.size and int(px.max()) >= 1 << depth:
        raise ValueError(f"samples do not fit {depth} bits")
    bpp = max(1, c * depth // 8)
    stream = [_filtered(_packed(px[y0::dy, x0::dx], depth), bpp, filters)
              .tobytes() for x0, y0, dx, dy, _, _ in
              _passes(w, h, int(interlace))]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(body, zlib.crc32(kind))))

    parts = [SIGNATURE, chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))]
    if palette is not None:
        parts.append(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    parts.append(chunk(b"IDAT", zlib.compress(b"".join(stream), 1)))  # fast
    parts.append(chunk(b"IEND", b""))
    return b"".join(parts)
