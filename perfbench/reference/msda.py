"""Multi-scale deformable attention as a plain gather (Deformable DETR's
bilinear sampling: zeros outside the level, half-pixel centres), written
out so that autograd takes every gradient.

One rule is stated rather than left to `grid_sample`: a sampling point
within `1e-4 + size * 2**-20` pixels of an integer position is split as
(lower corner, fraction ~1), not (that corner, fraction 0). The bilinear
value is the same either way; the gradient with respect to the location
is not, and seeded weights put the first step's points exactly on the
pixel lattice, where the two one-sided derivatives differ. The measured
package takes this rule (its MSDA contract), and a different but equally
valid rule would make every first step's offset gradient disagree.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """value [B, S, H, D], loc [B, Lq, H, L, P, 2] (x, y) in [0, 1],
    attn [B, Lq, H, L, P] -> [B, Lq, H * D]."""
    B, S, H, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    out = value.new_zeros((B * H, Lq, D))
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, start:start + h * w].permute(0, 2, 1, 3).reshape(
            B * H, h * w, D)
        start += h * w
        x = loc[:, :, :, lvl, :, 0].transpose(1, 2) * w - 0.5  # [B, H, Lq, P]
        y = loc[:, :, :, lvl, :, 1].transpose(1, 2) * h - 0.5
        a = attn[:, :, :, lvl].transpose(1, 2)
        x0 = torch.floor(x.detach() - (1e-4 + w * 2.0 ** -20))
        y0 = torch.floor(y.detach() - (1e-4 + h * 2.0 ** -20))
        fx, fy = x - x0, y - y0
        for dy, dx, wc in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)),
                           (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
            cx, cy = x0 + dx, y0 + dy
            inside = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
            idx = (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long()
            rows = torch.gather(v, 1, idx.reshape(B * H, Lq * P, 1).expand(
                -1, -1, D)).reshape(B * H, Lq, P, D)
            wgt = torch.where(inside, wc * a, 0.0).reshape(B * H, Lq, P, 1)
            out = out + (rows * wgt).sum(2)
    return out.reshape(B, H, Lq, D).permute(0, 2, 1, 3).reshape(B, Lq, H * D)
