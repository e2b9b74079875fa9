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


def test_png_refuses_what_it_does_not_read():
    rgb = np.random.default_rng(0).integers(0, 256, (8, 6, 3), np.uint8)
    good = png.encode_png(rgb)
    assert png.decode_png_rgb(b"not a png") is None
    assert png.decode_png_rgb(b"") is None
    for kw in ({"depth": 16}, {"depth": 4}, {"interlace": 1}):
        with pytest.raises(NotImplementedError, match="§A, image formats"):
            png.decode_png_rgb(_with_ihdr(good, **kw))
    buf = io.BytesIO()  # a 16-bit gray file as Pillow writes it
    Image.fromarray(np.arange(48, dtype=np.uint16).reshape(6, 8) * 999
                    ).save(buf, format="PNG")
    with pytest.raises(NotImplementedError, match="bit depth 16"):
        png.decode_png_rgb(buf.getvalue())
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
