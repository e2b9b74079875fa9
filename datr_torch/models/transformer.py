"""Deformable transformer encoder/decoder layers (port of
datr_tpu/models/transformer.py:26-161): no dropout (datr_tpu's train steps
run deterministic); the decoder's query self-attention takes the CDN mask.

LayerNorms use eps 1e-5, as datr_tpu/models/norms.py:74-77 passes it, and
come from the norm factory (`fast_norm`). Every layer computes in its
`dtype`, as datr_tpu's do.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear, MSDeformAttn, linear, softmax
from .norms import layer_norm


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
    def __init__(self, d_model: int, d_ffn: int,
                 dtype: torch.dtype = torch.float32, fast_norm: bool = False):
        super().__init__()
        self.linear1 = Linear(d_model, d_ffn, dtype=dtype)
        self.linear2 = Linear(d_ffn, d_model, dtype=dtype)
        self.norm = layer_norm(d_model, dtype, fast_norm)

    def forward(self, x):
        return self.norm(x + self.linear2(F.relu(self.linear1(x))))


class MultiheadAttention(nn.Module):
    """Dense multi-head attention with separate q/k/v inputs and PyTorch's
    `in_proj_weight` / `out_proj` parameter layout, computed in `dtype`.

    In bf16 it takes flax's MultiHeadDotProductAttention(dtype=bf16)'s ops
    (datr_tpu/models/transformer.py:141-145, flax/linen/attention.py): the
    query divided by sqrt(depth) in bf16, the logits and jax's softmax in
    bf16, each rounded where flax rounds it. In f32 it takes
    scaled_dot_product_attention, which differs by f32 roundings.

    Split over `tp_size` ranks (parallel/mesh.py `apply_tp`) a rank holds
    n_heads / tp_size heads: its rows of each of the q / k / v chunks of
    `in_proj_weight`, the inputs entering the TP region (`tp.copy`), and
    `out_proj` sums the ranks' parts."""

    def __init__(self, d_model: int, n_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_heads, self.dtype = n_heads, dtype
        self.tp, self.tp_size = None, 1
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = Linear(d_model, d_model, dtype=dtype)

    def forward(self, q, k, v, attn_mask: Optional[torch.Tensor] = None):
        """q, k, v [B, N, C]; attn_mask [N, N] bool, True = may attend."""
        B, N, C = q.shape
        depth = C // self.n_heads
        H = self.n_heads // self.tp_size
        if self.tp is not None:
            q, k, v = (self.tp.copy(x) for x in (q, k, v))

        def heads(x, w, b):
            return linear(x, w, b, self.dtype).reshape(
                B, -1, H, depth).transpose(1, 2)

        q, k, v = (heads(x, w, b) for x, w, b in zip(
            (q, k, v), self.in_proj_weight.chunk(3),
            self.in_proj_bias.chunk(3)))
        if self.dtype != torch.bfloat16:
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)
        else:
            q = q / torch.tensor(math.sqrt(depth), dtype=self.dtype,
                                 device=q.device)
            logits = q @ k.transpose(-1, -2)
            if attn_mask is not None:
                logits = logits.masked_fill(~attn_mask,
                                            torch.finfo(self.dtype).min)
            o = softmax(logits) @ v
        return self.out_proj(o.transpose(1, 2).reshape(B, N, H * depth))


class DeformableEncoderLayer(nn.Module):
    def __init__(self, d_model: int = 256, d_ffn: int = 2048,
                 n_levels: int = 4, n_heads: int = 8, n_points: int = 4,
                 dtype: torch.dtype = torch.float32, fast_norm: bool = False):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                      dtype)
        self.norm1 = layer_norm(d_model, dtype, fast_norm)
        self.ffn = FFN(d_model, d_ffn, dtype, fast_norm)

    def forward(
        self,
        src: torch.Tensor,  # [B, S, C]
        pos: torch.Tensor,  # [B, S, C]
        reference_points: torch.Tensor,  # [B, S, L, 2]
        spatial_shapes: Tuple[Tuple[int, int], ...],
        padding_mask: Optional[torch.Tensor] = None,  # [B, S]
        value_src: Optional[torch.Tensor] = None,  # [B, S_all, C]
    ):
        """`value_src`: the whole sequence the attention samples, when
        `src` is this rank's share of it (sequence parallelism; the
        padding mask is then the whole sequence's)."""
        attn_out = self.self_attn(
            src + pos, reference_points,
            src if value_src is None else value_src, spatial_shapes,
            padding_mask)
        return self.ffn(self.norm1(src + attn_out))


class DeformableDecoderLayer(nn.Module):
    """Query self-attention -> deformable cross-attention -> FFN."""

    def __init__(self, d_model: int = 256, d_ffn: int = 2048,
                 n_levels: int = 4, n_heads: int = 8, n_points: int = 4,
                 dtype: torch.dtype = torch.float32, fast_norm: bool = False):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, n_heads, dtype)
        self.norm2 = layer_norm(d_model, dtype, fast_norm)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                       dtype)
        self.norm1 = layer_norm(d_model, dtype, fast_norm)
        self.ffn = FFN(d_model, d_ffn, dtype, fast_norm)

    def forward(
        self,
        tgt: torch.Tensor,  # [B, Nq, C]
        query_pos: torch.Tensor,  # [B, Nq, C]
        memory: torch.Tensor,  # [B, S, C]
        reference_points: torch.Tensor,  # [B, Nq, L, 4]
        spatial_shapes: Tuple[Tuple[int, int], ...],
        memory_padding_mask: Optional[torch.Tensor] = None,  # [B, S]
        self_attn_mask: Optional[torch.Tensor] = None,  # [Nq, Nq] True=attend
    ):
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt, self_attn_mask))
        ca = self.cross_attn(tgt + query_pos, reference_points, memory,
                             spatial_shapes, memory_padding_mask)
        tgt = self.norm1(tgt + ca)
        return self.ffn(tgt)
