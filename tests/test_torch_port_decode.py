"""The port's host decoders and the yuv420 packing against their references
on the CPU: `native.rgb_to_yuv420` against datr_tpu's (its C++ kernel and
its numpy form), `data/png.py` against Pillow bit for bit, `native.
decode_jpeg_rgb` against datr_tpu's libjpeg decoder bit for bit, and the
decode of a PNG COCO folder without PIL against datr_tpu's loader.

Lossless PNG and the same libjpeg make bit-equality the bar."""

import io
import struct
import sys
import zlib

import numpy as np
import pytest
import torch_port_threads  # noqa: F401  (torch threads under xdist)
from PIL import Image

from datr_torch import native as tnative
from datr_torch.data import coco as tcoco
from datr_torch.data import loader as tloader
from datr_torch.data import png
from datr_torch.data import transforms as ttf
from datr_tpu import native as jnative
from datr_tpu.data import coco as jcoco
from datr_tpu.data import loader as jloader
from datr_tpu.data import transforms as jtf

from test_torch_port_data import AUG, CANVAS, assert_batches_equal  # noqa: E402

H, W = 37, 53  # odd, so no row or pixel count is a multiple of anything


def _pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def _pixels(ctype: int, seed: int):
    """(pixels, palette) of colour type `ctype`."""
    rng = np.random.default_rng(seed)
    if ctype == 3:
        return (rng.integers(0, 20, (H, W), np.uint8),
                rng.integers(0, 256, (20, 3), np.uint8))
    c = png.CHANNELS[ctype]
    return rng.integers(0, 256, (H, W, c), np.uint8), None


# ---------------- yuv420 ----------------


@pytest.mark.parametrize("real_hw", [None, (70, 101), (95, 127), (1, 1)])
def test_rgb_to_yuv420_equals_datr_tpu(real_hw, monkeypatch):
    """Bit-equal to datr_tpu's C++ kernel (built here) and to its numpy
    form, with the chroma clamp to the real extent."""
    canvas = np.random.default_rng(3).integers(0, 256, (96, 128, 3),
                                               np.uint8)
    if real_hw is not None:  # zero pads beyond the real extent
        canvas[real_hw[0]:] = 0
        canvas[:, real_hw[1]:] = 0
    got = tnative.rgb_to_yuv420(canvas, real_hw)
    assert jnative.get_lib() is not None  # the C++ path of datr_tpu
    np.testing.assert_array_equal(got, jnative.rgb_to_yuv420(canvas, real_hw))
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    np.testing.assert_array_equal(got, jnative.rgb_to_yuv420(canvas, real_hw))
    assert got.shape == (96 * 128 * 3 // 2,) and got.dtype == np.uint8


def test_rgb_to_yuv420_refuses_odd_canvas_and_extent():
    with pytest.raises(ValueError, match="even canvas"):
        tnative.rgb_to_yuv420(np.zeros((95, 128, 3), np.uint8))
    with pytest.raises(ValueError, match="outside canvas"):
        tnative.rgb_to_yuv420(np.zeros((96, 128, 3), np.uint8), (97, 10))


# ---------------- PNG ----------------


@pytest.mark.parametrize("flt", ["cycled", *png.FILTERS])
@pytest.mark.parametrize("ctype", sorted(png.CHANNELS))
def test_png_equals_pillow(ctype, flt):
    """The port's encoder writes each filter (or all five cycled over the
    rows); the port's decoder reads what Pillow reads, bit for bit."""
    px, pal = _pixels(ctype, seed=ctype)
    data = png.encode_png(px, pal,
                          png.FILTERS if flt == "cycled" else (flt,))
    got = png.decode_png_rgb(data)
    assert got.shape == (H, W, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _pil_rgb(data))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_written_by_pillow(mode):
    """Files Pillow writes (its own filter choice, a tRNS chunk for the
    palette image): the same pixels as Pillow reads back."""
    rng = np.random.default_rng(11)
    if mode == "P":
        im = Image.fromarray(rng.integers(0, 40, (H, W), np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 40 * 3, np.uint8).tolist())
        im.info["transparency"] = 3
    else:
        c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        a = rng.integers(0, 256, (H, W, c), np.uint8)
        im = Image.fromarray(a[..., 0] if c == 1 else a, mode)
    buf = io.BytesIO()
    im.save(buf, format="PNG", **({"transparency": 3} if mode == "P" else {}))
    data = buf.getvalue()
    np.testing.assert_array_equal(png.decode_png_rgb(data), _pil_rgb(data))


def _with_ihdr(data: bytes, **fields) -> bytes:
    """`data` with IHDR fields replaced (and its CRC redone)."""
    names = ("w", "h", "depth", "ctype", "comp", "filt", "interlace")
    vals = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    vals.update(fields)
    body = struct.pack(">IIBBBBB", *(vals[n] for n in names))
    crc = struct.pack(">I", zlib.crc32(body, zlib.crc32(b"IHDR")))
    return data[:16] + body + crc + data[33:]


def _kind_pixels(ctype: int, depth: int, seed: int):
    """(samples, palette) of colour type `ctype` at `depth` bits: uint16 at
    16 (with small values among them, where gray clips), a palette shorter
    than the index range (its missing entries read as black)."""
    rng = np.random.default_rng(seed)
    c = png.CHANNELS[ctype]
    dt = np.uint16 if depth == 16 else np.uint8
    px = rng.integers(0, 1 << depth, (H, W, c)).astype(dt)
    if depth == 16:
        px.flat[:300] = np.arange(300)
    if ctype == 3:
        n = max(1, (1 << depth) * 3 // 4)
        return px[..., 0], rng.integers(0, 256, (n, 3), np.uint8)
    return px, None


PNG_KINDS = [(ctype, depth) for ctype, depths in sorted(png.DEPTHS.items())
             for depth in depths]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", PNG_KINDS)
def test_png_every_kind_equals_pillow(ctype, depth, interlace):
    """Every colour type at every bit depth the PNG specification allows
    it, plain and Adam7-interlaced (written here: Pillow writes no
    Adam7), the five filters cycled over each pass's rows: bit for bit
    what Pillow's `convert("RGB")` gives (sub-8-bit gray scaled, 16-bit
    gray clipped, 16-bit colour's high bytes); each pass's C++ unfilter
    bitwise its numpy form."""
    px, pal = _kind_pixels(ctype, depth, seed=10 * ctype + depth)
    data = png.encode_png(px, pal, depth=depth, interlace=interlace)
    got = png.decode_png_rgb(data)
    assert got.shape == (H, W, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _pil_rgb(data))
    raw = np.frombuffer(zlib.decompress(data[data.index(b"IDAT") + 4:
                                             data.index(b"IEND") - 8]),
                        np.uint8)
    c = png.CHANNELS[ctype]
    bpp, pos = max(1, c * depth // 8), 0
    for *_, pw, ph in png._passes(W, H, int(interlace)):
        rb = (pw * c * depth + 7) // 8
        src = raw[pos:pos + ph * (rb + 1)]
        np.testing.assert_array_equal(png.unfilter(src, ph, rb, bpp),
                                      png.unfilter_plain(src, ph, rb, bpp))
        pos += ph * (rb + 1)
    assert pos == len(raw)


@pytest.mark.parametrize("case", ["pillow_16bit_gray", "header_depth16",
                                  "header_depth4", "header_interlace"])
def test_png_formerly_refused_kinds_equal_pillow(case):
    """The kinds the decoder used to refuse: a 16-bit gray file as Pillow
    writes it, and an 8-bit RGB file's IHDR rewritten to bit depth 16, to
    bit depth 4 as gray (each a valid PNG of other pixels), and a
    one-pixel file's to Adam7."""
    rgb = np.random.default_rng(0).integers(0, 256, (8, 6, 3), np.uint8)
    if case == "pillow_16bit_gray":
        buf = io.BytesIO()
        Image.fromarray(np.arange(48, dtype=np.uint16).reshape(6, 8) * 999
                        ).save(buf, format="PNG")
        data = buf.getvalue()
    else:
        kw = {"header_depth16": dict(w=3, depth=16),
              "header_depth4": dict(w=36, ctype=0, depth=4),
              "header_interlace": dict(interlace=1)}[case]
        if case == "header_interlace":  # one pixel: Adam7's first pass
            rgb = rgb[:1, :1]
        data = _with_ihdr(png.encode_png(rgb, filters=(0,)), **kw)
    np.testing.assert_array_equal(png.decode_png_rgb(data), _pil_rgb(data))


def test_png_refuses_what_it_does_not_read():
    """Malformed PNGs raise ValueError: headers outside the specification,
    CRC faults, truncation, an unknown filter type."""
    rgb = np.random.default_rng(0).integers(0, 256, (8, 6, 3), np.uint8)
    good = png.encode_png(rgb)
    assert png.decode_png_rgb(b"not a png") is None
    assert png.decode_png_rgb(b"") is None
    for kw in ({"depth": 3}, {"ctype": 3, "depth": 16}, {"ctype": 5},
               {"interlace": 2}, {"comp": 1}, {"filt": 1}, {"w": 0}):
        with pytest.raises(ValueError, match="malformed PNG header"):
            png.decode_png_rgb(_with_ihdr(good, **kw))
    with pytest.raises(ValueError, match="truncated"):  # Adam7 needs more
        png.decode_png_rgb(_with_ihdr(good, interlace=1))
    bad_crc = bytearray(good)
    bad_crc[40] ^= 1  # inside IDAT
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png_rgb(bytes(bad_crc))
    with pytest.raises(ValueError, match="truncated"):
        png.decode_png_rgb(good[:len(good) // 2])
    # a valid stream with a filter type outside 0-4 on its third row
    rows = np.zeros((8, 1 + 6 * 3), np.uint8)
    rows[2, 0] = 7
    body = zlib.compress(rows.tobytes())
    idat = (struct.pack(">I", len(body)) + b"IDAT" + body
            + struct.pack(">I", zlib.crc32(body, zlib.crc32(b"IDAT"))))
    start = good.index(b"IDAT") - 4
    end = good.index(b"IEND") - 4
    with pytest.raises(ValueError, match="row 2 has an unknown filter"):
        png.decode_png_rgb(good[:start] + idat + good[end:])
    with pytest.raises(ValueError, match="row 2 has an unknown filter"):
        png.unfilter_plain(rows.reshape(-1), 8, 18, 3)


# ---------------- JPEG ----------------


def _jpeg(img, quality=90):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


@pytest.mark.parametrize("scale", [8, 6])
@pytest.mark.parametrize("gray", [False, True])
def test_jpeg_equals_datr_tpu(scale, gray):
    """Bit-equal to datr_tpu's libjpeg decoder at full scale and at 6/8
    (DCT-domain scaling, ceil(dim * 6 / 8)); at full scale also to PIL."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (101, 163) if gray else (101, 163, 3),
                       np.uint8)
    data = _jpeg(img)
    got = tnative.decode_jpeg_rgb(data, scale_num=scale)
    want = jnative.decode_jpeg_rgb(data, scale_num=scale)
    assert want is not None  # datr_tpu's library was built with libjpeg
    assert got.shape == (-(-101 * scale // 8), -(-163 * scale // 8), 3)
    np.testing.assert_array_equal(got, want)
    if scale == 8:
        np.testing.assert_array_equal(got, _pil_rgb(data))


def test_jpeg_refuses_as_datr_tpu_does():
    """Non-JPEG input and a header-only prefix give None on both sides
    (tests/test_native_image_ops.py:134-150)."""
    data = _jpeg(np.random.default_rng(10).integers(0, 256, (64, 64, 3),
                                                    np.uint8))
    for bad in (b"", b"not a jpeg at all", b"\x89PNG\r\n\x1a\n" + b"\0" * 64,
                data[:20]):
        assert jnative.decode_jpeg_rgb(bad) is None
        assert tnative.decode_jpeg_rgb(bad) is None


def test_jpeg_encoder_round_trip():
    """The port's encoder (request bodies without PIL) writes a JPEG that
    PIL and the port decode alike."""
    img = np.random.default_rng(12).integers(0, 256, (50, 70, 3), np.uint8)
    data = tnative.encode_jpeg_rgb(img, quality=90)
    got = tnative.decode_jpeg_rgb(data)
    np.testing.assert_array_equal(got, _pil_rgb(data))
    assert np.abs(got.astype(int) - img).mean() < 60  # it is the image
    with pytest.raises(ValueError, match=r"\[h, w, 3\]"):
        tnative.encode_jpeg_rgb(img[..., 0])


def test_jpeg_library_missing_raises(monkeypatch):
    """Where the machine has no libjpeg, a JPEG raises RuntimeError (a
    non-JPEG still gives None); decode_rgb then takes PIL where it is."""
    def missing():
        raise RuntimeError("the host library jpeg_codec is unavailable")

    monkeypatch.setattr(tnative, "jpeg_library", missing)
    data = _jpeg(np.full((16, 16, 3), 77, np.uint8))
    assert tnative.decode_jpeg_rgb(b"not a jpeg") is None
    with pytest.raises(RuntimeError, match="jpeg_codec"):
        tnative.decode_jpeg_rgb(data)
    np.testing.assert_array_equal(tcoco.decode_rgb(data), _pil_rgb(data))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="jpeg_codec"):
        tcoco.decode_rgb(data)


# ---------------- files without PIL ----------------


def test_decode_rgb_without_pil(monkeypatch):
    """PNG and JPEG bodies decode with PIL blocked, as on the card's
    machine."""
    img = np.random.default_rng(4).integers(0, 256, (30, 40, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    jpg = _jpeg(img)
    want_jpg = _pil_rgb(jpg)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(tcoco.decode_rgb(buf.getvalue()), img)
    np.testing.assert_array_equal(tcoco.decode_rgb(jpg), want_jpg)


def test_png_folder_training_batch_equals_datr_tpu_without_pil(
        tmp_path, monkeypatch):
    """Single-domain training on a PNG COCO folder (Cityscapes' format):
    the port's loader with PIL blocked gives datr_tpu's first batches (read
    through PIL), every key np.array_equal."""
    from test_torch_port_data import _write_coco

    _write_coco(tmp_path / "single", "train", 4, 4)
    root = str(tmp_path)
    kw = dict(max_boxes=8, seed=5, epoch=1, num_threads=2)
    want = list(jloader.make_single_loader(
        jcoco.build_dataset("train", "single", root), 2, CANVAS,
        jtf.SingleDomainTrainTransform(**AUG, strong_aug=True), **kw))
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = list(tloader.make_single_loader(
        tcoco.build_dataset("train", "single", root), 2, CANVAS,
        ttf.SingleDomainTrainTransform(**AUG, strong_aug=True), **kw))
    assert_batches_equal(got, want)
