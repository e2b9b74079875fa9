"""Host-side image constants and resize geometry (own copy of
datr_tpu/data/transforms.py:20-44)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def get_size_with_aspect_ratio(
    image_size: Tuple[int, int], size: int, max_size: Optional[int] = None
) -> Tuple[int, int]:
    """(w, h) -> output (h, w): short side `size`, long side capped."""
    w, h = image_size
    if max_size is not None:
        min_original = float(min(w, h))
        max_original = float(max(w, h))
        if max_original / min_original * size > max_size:
            size = int(round(max_size * min_original / max_original))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        ow = size
        oh = int(size * h / w)
    else:
        oh = size
        ow = int(size * w / h)
    return oh, ow
