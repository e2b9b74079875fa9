"""The port's host image ops in C++ (datr_torch/csrc/image_ops.cpp through
`native`) against datr_tpu's C++ (datr_tpu/native/image_ops.cpp, which
datr_tpu runs wherever g++ builds it, as here) and against the port's own
plain numpy versions, on the CPU: `resize_normalize_pad`,
`resize_pad_u8` and `rgb_to_yuv420` bitwise equal to datr_tpu's over
seeded sizes (down- and upscales, unscaled, extents that fill the canvas
or leave a pad, one-pixel images and extents, real-extent clamps of the
chroma); `resize_normalize_pad` and `rgb_to_yuv420` bitwise equal to the
plain versions, `resize_pad_u8` within one count of its plain version
(datr_tpu's numpy fallback, float64 weights); the same bytes from eight
threads at once; malformed input refused before any pointer is passed;
no numpy fallback where the library cannot be built."""

import threading

import numpy as np
import pytest
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch import native as tnative
from datr_torch.data import transforms as ttf
from datr_tpu import native as jnative

# (source hw, resized extent, canvas)
RESIZES = [((96, 128), (96, 128), (96, 128)),  # unscaled, fills the canvas
           ((80, 110), (64, 88), (96, 128)),  # downscale, padded
           ((37, 53), (96, 128), (96, 128)),  # upscale
           ((200, 90), (96, 43), (100, 64)),
           ((1024, 2048), (667, 1333), (800, 1344)),  # the serving resize
           ((1, 1), (7, 5), (8, 8)),
           ((31, 17), (1, 1), (2, 2)),
           ((3, 640), (2, 301), (4, 302))]
# (canvas hw, real extent)
YUV = [((96, 128), None), ((96, 128), (70, 101)), ((96, 128), (95, 127)),
       ((96, 128), (1, 1)), ((800, 1344), (667, 1333)), ((2, 2), (1, 2))]


def _image(hw, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (*hw, 3), dtype=np.uint8)


def _canvas(hw, real_hw, seed):
    """A canvas whose pad beyond `real_hw` is zero, as the server packs
    it; pure red / blue pixels (chroma past 255 before the clamp) too."""
    c = _image(hw, seed)
    c[0, :2] = (255, 0, 0)
    c[-1, -2:] = (0, 0, 255)
    if real_hw is not None:
        c[real_hw[0]:] = 0
        c[:, real_hw[1]:] = 0
    return c


def test_the_cpp_paths_run():
    assert jnative.get_lib() is not None  # datr_tpu's C++, not its numpy
    lib = tnative.image_ops_library()
    assert all(hasattr(lib, n) for n in tnative.IMAGE_OPS_SIGNATURES)


@pytest.mark.parametrize("src_hw,out_hw,canvas_hw", RESIZES)
def test_resize_normalize_pad_bitwise(src_hw, out_hw, canvas_hw):
    img = _image(src_hw, sum(src_hw))
    args = (img, out_hw, canvas_hw, ttf.IMAGENET_MEAN, ttf.IMAGENET_STD)
    got = tnative.resize_normalize_pad(*args)
    assert got.dtype == np.float32 and got.shape == (*canvas_hw, 3)
    np.testing.assert_array_equal(got, jnative.resize_normalize_pad(*args))
    np.testing.assert_array_equal(got,
                                  tnative.resize_normalize_pad_plain(*args))
    assert not got[out_hw[0]:].any() and not got[:, out_hw[1]:].any()


@pytest.mark.parametrize("src_hw,out_hw,canvas_hw", RESIZES)
def test_resize_pad_u8_bitwise(src_hw, out_hw, canvas_hw):
    img = _image(src_hw, 7 + sum(src_hw))
    got = tnative.resize_pad_u8(img, out_hw, canvas_hw)
    assert got.dtype == np.uint8 and got.shape == (*canvas_hw, 3)
    np.testing.assert_array_equal(
        got, jnative.resize_pad_u8(img, out_hw, canvas_hw))
    plain = tnative.resize_pad_u8_plain(img, out_hw, canvas_hw)
    assert np.abs(got.astype(int) - plain).max() <= 1
    assert not got[out_hw[0]:].any() and not got[:, out_hw[1]:].any()


@pytest.mark.parametrize("canvas_hw,real_hw", YUV)
def test_rgb_to_yuv420_bitwise(canvas_hw, real_hw):
    canvas = _canvas(canvas_hw, real_hw, 3 + sum(canvas_hw))
    got = tnative.rgb_to_yuv420(canvas, real_hw)
    H, W = canvas_hw
    assert got.dtype == np.uint8 and got.shape == (H * W * 3 // 2,)
    np.testing.assert_array_equal(got, jnative.rgb_to_yuv420(canvas,
                                                             real_hw))
    np.testing.assert_array_equal(got,
                                  tnative.rgb_to_yuv420_plain(canvas,
                                                              real_hw))


def test_threads_get_the_same_bytes():
    """Eight threads at once (as the loader's and the server's threads
    call the library; ctypes releases the GIL) against one at a time."""
    imgs = [_image((300 + 7 * i, 500 - 5 * i), i) for i in range(8)]

    def work(img):
        c = tnative.resize_pad_u8(img, (150, 250), (160, 256))
        n = tnative.resize_normalize_pad(img, (150, 250), (160, 256),
                                         ttf.IMAGENET_MEAN, ttf.IMAGENET_STD)
        return c, n, tnative.rgb_to_yuv420(c, (150, 250))

    want = [work(img) for img in imgs]
    got = [None] * len(imgs)

    def run(i):
        for _ in range(4):
            got[i] = work(imgs[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(imgs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_malformed_input_is_refused():
    img = _image((20, 30), 0)
    mean, std = ttf.IMAGENET_MEAN, ttf.IMAGENET_STD
    with pytest.raises(ValueError, match="outside canvas"):
        tnative.resize_pad_u8(img, (25, 30), (24, 32))
    with pytest.raises(ValueError, match="outside canvas"):
        tnative.resize_normalize_pad(img, (20, 0), (24, 32), mean, std)
    with pytest.raises(ValueError, match="uint8"):
        tnative.resize_pad_u8(img.astype(np.float32), (10, 15), (24, 32))
    with pytest.raises(ValueError, match="uint8"):
        tnative.resize_normalize_pad(img[..., :2], (10, 15), (24, 32), mean,
                                     std)
    with pytest.raises(ValueError, match="uint8"):
        tnative.resize_pad_u8(img[:0], (10, 15), (24, 32))
    with pytest.raises(ValueError, match="3 channels"):
        tnative.resize_normalize_pad(img, (10, 15), (24, 32), mean[:2], std)
    # a strided view is copied before its pointer is passed
    view = _image((40, 60), 1)[::2, ::2]
    np.testing.assert_array_equal(
        tnative.resize_pad_u8(view, (10, 15), (24, 32)),
        jnative.resize_pad_u8(np.ascontiguousarray(view), (10, 15),
                              (24, 32)))


def test_no_numpy_fallback(monkeypatch, tmp_path):
    """Where the library cannot be built the calls raise; they never run
    the plain versions instead."""
    monkeypatch.setattr(tnative, "_host_libs", {})
    monkeypatch.setattr(tnative, "CSRC_DIR", tmp_path)  # no image_ops.cpp
    img = _image((20, 30), 0)
    with pytest.raises(RuntimeError, match="image_ops is unavailable"):
        tnative.resize_pad_u8(img, (10, 15), (24, 32))
    with pytest.raises(RuntimeError, match="image_ops is unavailable"):
        tnative.resize_normalize_pad(img, (10, 15), (24, 32),
                                     ttf.IMAGENET_MEAN, ttf.IMAGENET_STD)
    with pytest.raises(RuntimeError, match="image_ops is unavailable"):
        tnative.rgb_to_yuv420(np.zeros((24, 32, 3), np.uint8))
