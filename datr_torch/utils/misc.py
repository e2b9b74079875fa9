"""Small numeric helpers (port of datr_tpu/utils/misc.py:16-46)."""

from __future__ import annotations

import math

import torch


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)


def _sine(coord: torch.Tensor, dim_t: torch.Tensor) -> torch.Tensor:
    """[..., ] -> [..., F]: sin on even features, cos on odd, interleaved."""
    p = coord[..., None] / dim_t
    return torch.stack(
        [p[..., 0::2].sin(), p[..., 1::2].cos()], dim=-1
    ).reshape(*p.shape[:-1], dim_t.shape[0])


def sine_embed_for_position(pos: torch.Tensor,
                            num_feats: int = 128) -> torch.Tensor:
    """Sine embedding of normalized positions.

    pos: [..., 2] or [..., 4] (x, y[, w, h]) in [0, 1]. Returns
    [..., 2*num_feats] or [..., 4*num_feats], ordered (y, x[, w, h])."""
    scale = 2.0 * math.pi
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=pos.device)
    dim_t = 10000.0 ** (2.0 * torch.floor(dim_t / 2.0) / num_feats)

    def embed(coord):
        return _sine(coord * scale, dim_t)

    pos_x = embed(pos[..., 0])
    pos_y = embed(pos[..., 1])
    if pos.shape[-1] == 2:
        return torch.cat([pos_y, pos_x], dim=-1)
    pos_w = embed(pos[..., 2])
    pos_h = embed(pos[..., 3])
    return torch.cat([pos_y, pos_x, pos_w, pos_h], dim=-1)
