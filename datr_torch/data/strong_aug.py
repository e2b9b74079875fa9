"""Strong photometric augmentation for the target domain (port of
datr_tpu/data/strong_aug.py on uint8 [H, W, 3] arrays; PIL's enhancers,
HSV conversion and blur come from `pil_ops`).

RandomApply(ColorJitter(.4, .4, .4, .1), p=.8) + RandomGrayscale(.2) +
RandomApply(GaussianBlur(sigma in [.1, 2]), p=.5), photometric only, so the
weak and strong views keep one geometry. Every draw is made from the
caller's `random.Random` in datr_tpu's order, so the two pipelines consume
the same stream.
"""

from __future__ import annotations

import random

import numpy as np

from . import pil_ops


def _adjust_contrast(arr, f):
    mean = arr.mean(axis=(0, 1), keepdims=True)
    return (arr - mean) * f + mean


def _adjust_hue(img: np.ndarray, shift: float) -> np.ndarray:
    """shift in [-0.5, 0.5] turns of the hue wheel: the HSV round trip
    with a uint8 wrap-around of H (torchvision's PIL adjust_hue)."""
    hsv = pil_ops.rgb_to_hsv(img)
    # uint8 wraparound IS the mod-256 hue roll
    hsv[..., 0] += np.uint8(int(shift * 255) % 256)
    return pil_ops.hsv_to_rgb(hsv)


def color_jitter(
    img: np.ndarray, rng: random.Random,
    brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1,
) -> np.ndarray:
    """torchvision ColorJitter on PIL's enhancers and HSV hue, in a random
    order. The draws follow ColorJitter.get_params: the permutation first,
    then the four factors in (brightness, contrast, saturation, hue)
    order."""
    order = [0, 1, 2, 3]
    rng.shuffle(order)
    f_b = (rng.uniform(max(0, 1 - brightness), 1 + brightness)
           if brightness > 0 else 1.0)
    f_c = (rng.uniform(max(0, 1 - contrast), 1 + contrast)
           if contrast > 0 else 1.0)
    f_s = (rng.uniform(max(0, 1 - saturation), 1 + saturation)
           if saturation > 0 else 1.0)
    s_h = rng.uniform(-hue, hue) if hue > 0 else 0.0
    ops = [
        lambda im: pil_ops.brightness(im, f_b) if brightness > 0 else im,
        lambda im: pil_ops.contrast(im, f_c) if contrast > 0 else im,
        lambda im: pil_ops.color(im, f_s) if saturation > 0 else im,
        lambda im: _adjust_hue(im, s_h) if hue > 0 else im,
    ]
    for i in order:
        img = ops[i](img)
    return img


def to_grayscale(img: np.ndarray) -> np.ndarray:
    """`img.convert("L").convert("RGB")`."""
    return pil_ops.gray_to_rgb(pil_ops.to_gray_l(img))


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    return pil_ops.gaussian_blur(img, sigma)


def strong_augment(img: np.ndarray, rng: random.Random) -> np.ndarray:
    """The full strong-aug chain (reference DAcoco.py:348-361)."""
    if rng.random() < 0.8:
        img = color_jitter(img, rng)
    if rng.random() < 0.2:
        img = to_grayscale(img)
    if rng.random() < 0.5:
        img = gaussian_blur(img, rng.uniform(0.1, 2.0))
    return img


# --- sltransform extras of the single-domain strong_aug path -------------
def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    arr = np.asarray(img, np.float32) / 255.0
    arr = np.clip(_adjust_contrast(arr, factor), 0, 1)
    return (arr * 255 + 0.5).astype(np.uint8)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    arr = np.asarray(img, np.float32) / 255.0
    arr = np.clip(arr * factor, 0, 1)
    return (arr * 255 + 0.5).astype(np.uint8)


def lighting_noise(img: np.ndarray, rng: random.Random) -> np.ndarray:
    """Random channel permutation (sltransform.py:52 LightingNoise)."""
    perms = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1),
             (2, 1, 0)]
    p = perms[rng.randrange(len(perms))]
    return np.ascontiguousarray(np.asarray(img)[..., list(p)])


def random_select_multi(ops, rng: random.Random):
    """Pick one op from a list (sltransform.py:202 RandomSelectMulti)."""
    return ops[rng.randrange(len(ops))]
