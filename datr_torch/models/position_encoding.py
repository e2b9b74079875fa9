"""Sine position embeddings with separate H/W temperatures (port of
datr_tpu/models/position_encoding.py:17-44). Batch-first, channels-last."""

from __future__ import annotations

import math

import torch

from ..utils.misc import _sine


def position_embedding_sine_hw(
    mask: torch.Tensor,  # [B, H, W] True = padding
    num_pos_feats: int = 128,
    temperature_h: float = 10000.0,
    temperature_w: float = 10000.0,
) -> torch.Tensor:
    """Returns [B, H, W, 2*num_pos_feats] (y-embed then x-embed), positions
    normalized to (0, 2*pi] over the unpadded extent."""
    not_mask = (~mask).to(torch.float32)
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    eps, scale = 1e-6, 2.0 * math.pi
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale

    def embed(coord, temperature):
        dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                             device=mask.device)
        dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0)
                                / num_pos_feats)
        return _sine(coord, dim_t)

    return torch.cat(
        [embed(y_embed, temperature_h), embed(x_embed, temperature_w)],
        dim=-1,
    )
