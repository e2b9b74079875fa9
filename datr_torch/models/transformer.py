"""Deformable transformer encoder/decoder layers (port of
datr_tpu/models/transformer.py:26-161), eval path: no dropout, no CDN mask.

LayerNorms use eps 1e-5, as datr_tpu/models/norms.py:74-77 passes it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MSDeformAttn


def encoder_reference_points(
    spatial_shapes: Tuple[Tuple[int, int], ...],
    valid_ratios: torch.Tensor,  # [B, L, 2] (w_ratio, h_ratio)
) -> torch.Tensor:
    """Normalized (x, y) grid centres of every token at every level,
    [B, S, L, 2]."""
    dev = valid_ratios.device
    points = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        ry = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
        rx = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
        gy, gx = torch.meshgrid(ry, rx, indexing="ij")
        gy = gy.reshape(-1)[None] / (valid_ratios[:, None, lvl, 1] * h)
        gx = gx.reshape(-1)[None] / (valid_ratios[:, None, lvl, 0] * w)
        points.append(torch.stack([gx, gy], dim=-1))  # [B, hw, 2]
    ref = torch.cat(points, dim=1)  # [B, S, 2]
    return ref[:, :, None, :] * valid_ratios[:, None, :, :]


def valid_ratios_from_mask(masks) -> torch.Tensor:
    """[B, L, 2] fraction of unpadded width/height per level; masks: list of
    [B, h, w] bool, True = pad."""
    ratios = []
    for m in masks:
        h, w = m.shape[1], m.shape[2]
        valid_h = (~m[:, :, 0]).sum(1).to(torch.float32) / h
        valid_w = (~m[:, 0, :]).sum(1).to(torch.float32) / w
        ratios.append(torch.stack([valid_w, valid_h], dim=-1))
    return torch.stack(ratios, dim=1)


class FFN(nn.Module):
    def __init__(self, d_model: int, d_ffn: int):
        super().__init__()
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x):
        return self.norm(x + self.linear2(F.relu(self.linear1(x))))


class MultiheadAttention(nn.Module):
    """Dense multi-head attention with separate q/k/v inputs and PyTorch's
    `in_proj_weight` / `out_proj` parameter layout."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q, k, v):  # each [B, N, C]
        B, N, C = q.shape
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def heads(x, w, b):
            return F.linear(x, w, b).reshape(B, -1, self.n_heads,
                                             C // self.n_heads).transpose(1, 2)

        o = F.scaled_dot_product_attention(
            heads(q, wq, bq), heads(k, wk, bk), heads(v, wv, bv))
        return self.out_proj(o.transpose(1, 2).reshape(B, N, C))


class DeformableEncoderLayer(nn.Module):
    def __init__(self, d_model: int = 256, d_ffn: int = 2048,
                 n_levels: int = 4, n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.ffn = FFN(d_model, d_ffn)

    def forward(
        self,
        src: torch.Tensor,  # [B, S, C]
        pos: torch.Tensor,  # [B, S, C]
        reference_points: torch.Tensor,  # [B, S, L, 2]
        spatial_shapes: Tuple[Tuple[int, int], ...],
        padding_mask: Optional[torch.Tensor] = None,  # [B, S]
    ):
        attn_out = self.self_attn(src + pos, reference_points, src,
                                  spatial_shapes, padding_mask)
        return self.ffn(self.norm1(src + attn_out))


class DeformableDecoderLayer(nn.Module):
    """Query self-attention -> deformable cross-attention -> FFN."""

    def __init__(self, d_model: int = 256, d_ffn: int = 2048,
                 n_levels: int = 4, n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, n_heads)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.ffn = FFN(d_model, d_ffn)

    def forward(
        self,
        tgt: torch.Tensor,  # [B, Nq, C]
        query_pos: torch.Tensor,  # [B, Nq, C]
        memory: torch.Tensor,  # [B, S, C]
        reference_points: torch.Tensor,  # [B, Nq, L, 4]
        spatial_shapes: Tuple[Tuple[int, int], ...],
        memory_padding_mask: Optional[torch.Tensor] = None,  # [B, S]
    ):
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt))
        ca = self.cross_attn(tgt + query_pos, reference_points, memory,
                             spatial_shapes, memory_padding_mask)
        tgt = self.norm1(tgt + ca)
        return self.ffn(tgt)
