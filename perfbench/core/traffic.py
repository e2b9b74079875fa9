"""The one traffic generator: every mix under perfbench/traffic/ is data
that this module reads: training batches, frames, and a closed loop's
clients or an open loop's arrivals (steady, or in phases such as on/off
bursts). A seed changes the order of the work and the content of the
images, never the amount: every seed gets the same set of image extents,
box counts and frame sizes, each in its own order, and the same arrival
schedule.

Frames copy the measured package's `tools/serve_bench.py`
`synthetic_frames` recipe (upsampled coarse noise, hard-edged rectangles,
about 1% sensor noise), drawn on the device from a generator.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _gen(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))


def _perm(seed: int, stream: int, n: int) -> List[int]:
    g = torch.Generator().manual_seed((int(seed) * 7919 + stream) % (2 ** 63))
    return torch.randperm(n, generator=g).tolist()


def _content(g: torch.Generator, n: int, hw: Tuple[int, int], device,
             rects: int = 12) -> torch.Tensor:
    """n images [n, h, w, 3] in [0, 1]: coarse noise blown up, rectangles,
    sensor noise."""
    h, w = hw
    cell = max(1, min(h, w) // 32)
    coarse = torch.rand((n, 3, -(-h // cell), -(-w // cell)), generator=g,
                        device=device)
    img = coarse.repeat_interleave(cell, 2).repeat_interleave(cell, 3)[
        :, :, :h, :w].permute(0, 2, 3, 1).contiguous()
    u = torch.rand((n, rects, 7), generator=g, device=device).tolist()
    for i in range(n):
        for y, x, rh, rw, r, gg, b in u[i]:
            y0, x0 = int(y * (h - h // 8)), int(x * (w - w // 8))
            hh = int(h // 64 + 1 + rh * (h // 4 - h // 64))
            ww = int(w // 64 + 1 + rw * (w // 4 - w // 64))
            img[i, y0:y0 + hh, x0:x0 + ww] = torch.tensor(
                [r, gg, b], device=device)
    img += 0.01 * torch.randn(img.shape, generator=g, device=device)
    return img.clamp(0.0, 1.0)


def to_u8(img: torch.Tensor) -> np.ndarray:
    return (img * 255).to(torch.uint8).cpu().numpy()


# ---------------------------------------------------------------- training


def train_batches(mix: Dict, num_classes: int, canvas: Sequence[int],
                  seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """`mix["distinct"]` paired batches on the device: `source_images` +
    `target_images` normalized images on the canvas (pads zeroed), the pad
    mask, and the source images' boxes (cxcywh, relative to the real
    extent), labels and valid flags, padded to `max_boxes`."""
    ns, nt, T = mix["source_images"], mix["target_images"], mix["max_boxes"]
    H, W = canvas
    n = mix["distinct"]
    ext = [mix["extents"][i % len(mix["extents"])] for i in range(n * (ns + nt))]
    ext = [ext[i] for i in _perm(seed, 1, len(ext))]
    counts = [mix["boxes_per_image"][i % len(mix["boxes_per_image"])]
              for i in range(n * ns)]
    counts = [counts[i] for i in _perm(seed, 2, len(counts))]
    g = _gen(seed, 3, device)
    mean = torch.tensor(MEAN, device=device)
    std = torch.tensor(STD, device=device)
    out = []
    for b in range(n):
        imgs = ((_content(g, ns + nt, (H, W), device) - mean) / std)
        pad = torch.ones((ns + nt, H, W), dtype=torch.bool, device=device)
        for i in range(ns + nt):
            h, w = ext[b * (ns + nt) + i]
            pad[i, :h, :w] = False
        imgs = imgs.masked_fill(pad[..., None], 0.0)
        boxes = torch.zeros((ns, T, 4), device=device)
        labels = torch.zeros((ns, T), dtype=torch.long, device=device)
        valid = torch.zeros((ns, T), dtype=torch.bool, device=device)
        for i in range(ns):
            k = counts[b * ns + i]
            wh = 0.03 + 0.3 * torch.rand((k, 2), generator=g, device=device)
            c = wh / 2 + (1 - wh) * torch.rand((k, 2), generator=g,
                                               device=device)
            boxes[i, :k] = torch.cat([c, wh], -1)
            labels[i, :k] = torch.randint(1, num_classes, (k,), generator=g,
                                          device=device)
            valid[i, :k] = True
        out.append({"images": imgs, "pad_mask": pad, "boxes": boxes,
                    "labels": labels, "valid": valid})
    return out


# ---------------------------------------------------------------- serving


def frame_sizes(mix: Dict) -> List[Tuple[int, int]]:
    """The distinct frames' (h, w): fixed sizes, or a long side with
    aspects (w:h) cycled."""
    f = mix["frames"]
    n = f["distinct"]
    if "hw" in f:
        return [tuple(f["hw"])] * n
    out = []
    for i in range(n):
        aw, ah = f["aspects"][i % len(f["aspects"])]
        L = f["long_side"]
        out.append((L, int(round(L * aw / ah))) if ah > aw
                   else (int(round(L * ah / aw)), L))
    return out


def base_frames(mix: Dict, seed: int, device) -> List[np.ndarray]:
    sizes = frame_sizes(mix)
    sizes = [sizes[i] for i in _perm(seed, 4, len(sizes))]
    g = _gen(seed, 5, device)
    return [to_u8(_content(g, 1, hw, device)[0]) for hw in sizes]


STAMP = 32  # px: a request's id, as one colour, in the top-left block


def stamped(frame: np.ndarray, rid: int) -> np.ndarray:
    """A copy of `frame` whose top-left STAMP x STAMP block holds `rid`
    (24 bits as one RGB colour): every request's image is its own."""
    out = frame.copy()
    out[:STAMP, :STAMP] = (rid & 255, (rid >> 8) & 255, (rid >> 16) & 255)
    return out


def stamp_of(canvas_u8: np.ndarray) -> int:
    """The id back from a canvas: the block's interior survives any resize
    by 0.4x or more unchanged."""
    r, g, b = (int(v) for v in canvas_u8[6, 6])
    return r | (g << 8) | (b << 16)


def frame_order(mix: Dict, seed: int, n: int) -> List[int]:
    """The base frame of each of n requests: the distinct frames cycled in
    a seeded order."""
    k = mix["frames"]["distinct"]
    perm = _perm(seed, 6, k)
    return [perm[i % k] for i in range(n)]


def _exp_gaps(rate: float, n: int, stream: int) -> List[float]:
    """n inter-arrival gaps of a Poisson process at `rate`: the exponential
    distribution's quantiles at (i + 0.5) / n, in an order fixed by
    `stream`."""
    gaps = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
    return [gaps[i] for i in _perm(0, stream, n)]


def arrival_times(mix: Dict, seconds: float) -> List[float]:
    """Every request's due time, in seconds from the window's start.

    The mix's `phases` ({"seconds", "rate_per_s"} each, cycled until the
    window ends) give on/off or stepped arrivals; without them the whole
    window is one phase at `rate_per_s`. A phase of d seconds at rate r
    holds round(r * d) Poisson arrivals (`_exp_gaps`, a stream of its own).
    The schedule is the same for every seed: a tail's reading depends on
    how the arrivals bunch, so the seed changes only the frames and which
    frame each request carries (`frame_order`)."""
    phases = mix.get("phases") or [{"seconds": seconds,
                                    "rate_per_s": mix["rate_per_s"]}]
    out: List[float] = []
    t, i = 0.0, 0
    while t < seconds - 1e-9:
        ph = phases[i % len(phases)]
        d = min(float(ph["seconds"]), seconds - t)
        n = int(round(ph["rate_per_s"] * d))
        if n:
            out.extend(t + c for c in np.cumsum(
                _exp_gaps(ph["rate_per_s"], n, 7 + 1000 * i)).tolist())
        t += d
        i += 1
    return sorted(out)
