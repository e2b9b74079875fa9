"""Host image work: the serving resize (`resize_pad_u8`), the training /
eval canvas step (`resize_normalize_pad`), the yuv420 wire's packing
(`rgb_to_yuv420`), all three in C++ (`csrc/image_ops.cpp`, the port's copy
of datr_tpu/native/image_ops.cpp, bitwise equal to it), and JPEG through
libjpeg (`decode_jpeg_rgb`, `encode_jpeg_rgb`). The three image functions'
plain numpy versions (`*_plain`) stay beside them for the tests and
chip_smoke.py to hold the C++ against: `resize_normalize_pad_plain` and
`rgb_to_yuv420_plain` are bitwise equal to it, `resize_pad_u8_plain`
(datr_tpu's numpy fallback, float64 weights) within one count.

The host routines in C++ (`csrc/*.cpp`) are built with g++ at first use
into build/datr_torch/ and loaded with ctypes (`host_library`), never at
import. A library that cannot be built raises where it is needed (there is
no fallback to numpy); it takes nothing else down with it (PNG decodes
without libjpeg)."""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from .ops._build import BUILD_DIR

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
JPEG_SOI = b"\xff\xd8"  # every JPEG stream starts with this marker

_host_lock = threading.Lock()
_host_libs: dict = {}  # stem -> loaded library, or the exception its build raised

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_PI = ctypes.POINTER(ctypes.c_int)
IMAGE_OPS_SIGNATURES = {
    "resize_normalize_pad": ([_P, _I, _I, _P, _I, _I, _I, _I, _P, _P], None),
    "resize_bilinear_u8": ([_P, _I, _I, _P, _I, _I], None),
    "rgb_to_yuv420": ([_P, _I, _I, _I, _I, _P], None),
}
# datr_tpu's flags (datr_tpu/native/__init__.py:27) without its -fopenmp:
# no fused multiply-adds, so the floats round as datr_tpu's build rounds
# them; one thread per call (csrc/image_ops.cpp says why)
IMAGE_OPS_FLAGS = ("-O3", "-ffp-contract=off")
JPEG_SIGNATURES = {
    "jpeg_probe": ([_P, _I64, _PI, _PI], _I),
    "jpeg_decode_rgb": ([_P, _I64, _I, _P, _I64, _PI, _PI], _I),
    "jpeg_encode_rgb": ([_P, _I, _I, _I,
                         ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
                         ctypes.POINTER(ctypes.c_ulong)], _I),
    "jpeg_free": ([ctypes.POINTER(ctypes.c_ubyte)], None),
}


def _build_host(src: Path, so: Path, link, flags):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # built in a private directory and renamed into place, so concurrent
    # builders (test workers) never load a partial file
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / so.name
        cmd = ["g++", *flags, "-shared", "-fPIC", "-std=c++17", str(src),
               "-o", str(out), *link]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ not found: cannot build {src.name}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"building {src.name} failed "
                               f"({' '.join(cmd)}):\n{proc.stderr[-3000:]}")
        os.replace(out, so)


def host_library(stem: str, signatures: dict, link=(), flags=("-O2",)):
    """The host library built from csrc/<stem>.cpp with g++ and compile
    `flags` (again when the source is newer than the build), loaded with
    ctypes and its entry points declared. A failed build raises
    RuntimeError with g++'s output, here and on every later call (it is not
    retried)."""
    with _host_lock:
        lib = _host_libs.get(stem)
        if lib is None:
            src = CSRC_DIR / f"{stem}.cpp"
            so = BUILD_DIR / f"lib{stem}.so"
            try:
                if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
                    _build_host(src, so, link, flags)
                lib = ctypes.CDLL(str(so))
                for name, (argtypes, restype) in signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes, fn.restype = argtypes, restype
            except (RuntimeError, OSError) as e:
                lib = RuntimeError(f"the host library {stem} is unavailable: "
                                   f"{e}")
            _host_libs[stem] = lib
    if isinstance(lib, Exception):
        raise lib
    return lib


def jpeg_library():
    """libjpeg through the port's csrc/jpeg_codec.cpp. Raises RuntimeError
    where the machine lacks jpeglib.h or libjpeg."""
    return host_library("jpeg_codec", JPEG_SIGNATURES, link=("-ljpeg",))


def image_ops_library():
    """csrc/image_ops.cpp, built with IMAGE_OPS_FLAGS."""
    return host_library("image_ops", IMAGE_OPS_SIGNATURES,
                        flags=IMAGE_OPS_FLAGS)


def _rgb_u8(img: np.ndarray) -> np.ndarray:
    """A C-contiguous uint8 [h, w, 3] image (h, w > 0), else ValueError:
    the C++ reads h * w * 3 bytes behind the pointer."""
    img = np.ascontiguousarray(img)
    if (img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3
            or 0 in img.shape):
        raise ValueError(f"expected a uint8 [h, w, 3] image, got "
                         f"{img.dtype} {img.shape}")
    return img


def _extent_in_canvas(out_hw, canvas_hw):
    dh, dw = int(out_hw[0]), int(out_hw[1])
    H, W = int(canvas_hw[0]), int(canvas_hw[1])
    if not (0 < dh <= H and 0 < dw <= W):
        raise ValueError(f"resized extent {(dh, dw)} outside canvas "
                         f"{(H, W)}")
    return dh, dw, H, W


def resize_pad_u8(img_u8: np.ndarray, out_hw, canvas_hw) -> np.ndarray:
    """Bilinear resize (align_corners=False) kept in uint8, zero-padded into
    an [H, W, 3] canvas at the top-left; f32 weights and arithmetic, u8 =
    trunc(v + 0.5) (csrc/image_ops.cpp resize_bilinear_u8)."""
    src = _rgb_u8(img_u8)
    dh, dw, H, W = _extent_in_canvas(out_hw, canvas_hw)
    lib = image_ops_library()
    dst = np.empty((dh, dw, 3), np.uint8)
    lib.resize_bilinear_u8(src.ctypes.data, src.shape[0], src.shape[1],
                           dst.ctypes.data, dh, dw)
    canvas = np.zeros((H, W, 3), np.uint8)
    canvas[:dh, :dw] = dst
    return canvas


def resize_pad_u8_plain(img_u8: np.ndarray, out_hw,
                        canvas_hw) -> np.ndarray:
    """`resize_pad_u8` in numpy, as datr_tpu's numpy fallback computes it
    (datr_tpu/native/__init__.py:257-275): float64 weights, so a few values
    in a thousand are one count off the C++."""
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
    into a float32 [H, W, 3] canvas (csrc/image_ops.cpp
    resize_normalize_pad)."""
    src = _rgb_u8(img_u8)
    dh, dw, H, W = _extent_in_canvas(out_hw, canvas_hw)
    m = np.ascontiguousarray(mean, np.float32)
    s = np.ascontiguousarray(std, np.float32)
    if m.shape != (3,) or s.shape != (3,):
        raise ValueError(f"mean / std of 3 channels expected, got "
                         f"{m.shape} / {s.shape}")
    lib = image_ops_library()
    dst = np.empty((H, W, 3), np.float32)
    lib.resize_normalize_pad(src.ctypes.data, src.shape[0], src.shape[1],
                             dst.ctypes.data, dh, dw, H, W, m.ctypes.data,
                             s.ctypes.data)
    return dst


def resize_normalize_pad_plain(img_u8: np.ndarray, out_hw, canvas_hw,
                               mean: np.ndarray,
                               std: np.ndarray) -> np.ndarray:
    """`resize_normalize_pad` in numpy: the C++'s arithmetic, every
    operation in float32 and in its order, so the canvases are bitwise
    equal. An unscaled image skips the sampling: its weights are exactly 1
    and 0."""
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


def _yuv_extent(canvas_u8: np.ndarray, real_hw):
    H, W = canvas_u8.shape[:2]
    if H % 2 or W % 2:
        raise ValueError(f"yuv420 needs an even canvas, got {(H, W)}")
    rh, rw = (int(real_hw[0]), int(real_hw[1])) if real_hw else (H, W)
    if not (0 < rh <= H and 0 < rw <= W):
        raise ValueError(f"real extent {(rh, rw)} outside canvas {(H, W)}")
    return H, W, rh, rw


def rgb_to_yuv420(canvas_u8: np.ndarray, real_hw=None) -> np.ndarray:
    """Planar I420 (YUV 4:2:0, full-range BT.601 / JFIF) of an RGB canvas:
    the yuv420 wire (1.5 bytes/px; csrc/image_ops.cpp rgb_to_yuv420).
    Chroma 2x2 averages clamp their samples to `real_hw`, so the zero pads
    never bleed into the chroma of real boundary pixels. Returns flat uint8
    [H*W*3//2]: the Y plane, then U, then V; H and W must be even."""
    H, W, rh, rw = _yuv_extent(canvas_u8, real_hw)
    src = _rgb_u8(canvas_u8)
    lib = image_ops_library()
    out = np.empty(H * W * 3 // 2, np.uint8)
    lib.rgb_to_yuv420(src.ctypes.data, H, W, rh, rw, out.ctypes.data)
    return out


def rgb_to_yuv420_plain(canvas_u8: np.ndarray, real_hw=None) -> np.ndarray:
    """`rgb_to_yuv420` in numpy, every operation in float32 as the C++ does
    it (datr_tpu/native/__init__.py:213-232): bitwise equal."""
    H, W, rh, rw = _yuv_extent(canvas_u8, real_hw)
    f = canvas_u8.astype(np.float32)
    y = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    yp = np.trunc(y + 0.5).astype(np.uint8)
    ri = np.minimum(np.arange(H), rh - 1)
    ci = np.minimum(np.arange(W), rw - 1)
    blk = f[ri][:, ci].reshape(H // 2, 2, W // 2, 2, 3).mean(axis=(1, 3))
    u = 128.0 - 0.168736 * blk[..., 0] - 0.331264 * blk[..., 1] \
        + 0.5 * blk[..., 2]
    v = 128.0 + 0.5 * blk[..., 0] - 0.418688 * blk[..., 1] \
        - 0.081312 * blk[..., 2]
    up = np.trunc(np.clip(u + 0.5, 0, 255)).astype(np.uint8)
    vp = np.trunc(np.clip(v + 0.5, 0, 255)).astype(np.uint8)
    return np.concatenate([yp.ravel(), up.ravel(), vp.ravel()])


def decode_jpeg_rgb(data: bytes, scale_num: int = 8):
    """JPEG bytes -> uint8 [h, w, 3] RGB through libjpeg, with the GIL
    released (own copy of datr_tpu/native/__init__.py:141-184). scale_num /
    8 is libjpeg's DCT-domain scaling: the output is ceil(h * scale_num /
    8) x ceil(w * scale_num / 8).

    Returns None where `data` is no decodable JPEG (no start-of-image
    marker, a corrupt or truncated header). Raises RuntimeError where the
    machine has no libjpeg to build against."""
    if len(data) < 2 or bytes(data[:2]) != JPEG_SOI:
        return None
    lib = jpeg_library()
    buf = np.frombuffer(data, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_probe(buf.ctypes.data, buf.size, ctypes.byref(h),
                      ctypes.byref(w)) != 0:
        return None
    s = min(max(int(scale_num), 1), 8)
    dh, dw = -(-h.value * s // 8), -(-w.value * s // 8)
    out = np.empty((dh, dw, 3), np.uint8)
    oh, ow = ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_decode_rgb(buf.ctypes.data, buf.size, s, out.ctypes.data,
                           out.size, ctypes.byref(oh), ctypes.byref(ow)) != 0:
        return None
    if (oh.value, ow.value) != (dh, dw):
        out = out.reshape(-1)[: oh.value * ow.value * 3].reshape(
            oh.value, ow.value, 3).copy()
    return out


def encode_jpeg_rgb(img_u8: np.ndarray, quality: int = 90) -> bytes:
    """uint8 [h, w, 3] RGB -> JPEG bytes (libjpeg's defaults: YCbCr 4:2:0,
    islow DCT). For request bodies where PIL is absent."""
    img = np.ascontiguousarray(img_u8, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3 or 0 in img.shape:
        raise ValueError(f"expected a [h, w, 3] image, got {img.shape}")
    lib = jpeg_library()
    out = ctypes.POINTER(ctypes.c_ubyte)()
    n = ctypes.c_ulong()
    if lib.jpeg_encode_rgb(img.ctypes.data, img.shape[0], img.shape[1],
                           int(quality), ctypes.byref(out),
                           ctypes.byref(n)) != 0:
        raise RuntimeError("libjpeg failed to encode the image")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.jpeg_free(out)
