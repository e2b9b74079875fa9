"""MLP head and the MSDeformAttn module (port of datr_tpu/models/layers.py).

Attribute names mirror the flax parameter tree (`layer0`, `value_proj`,
`sampling_offsets`, ...) so converted weights load by a mechanical walk
(datr_torch/convert.py).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import msda


class MLP(nn.Module):
    """ReLU MLP with layers `layer0` .. `layer{n-1}`."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int, last_zero_init: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.last_zero_init = last_zero_init
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        for i in range(num_layers):
            self.add_module(f"layer{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


def directional_offset_bias(n_heads: int, n_levels: int,
                            n_points: int) -> torch.Tensor:
    """Initial sampling-offset bias: heads point at evenly spaced directions,
    points at increasing radii (datr_tpu/models/layers.py:48-56)."""
    thetas = torch.arange(n_heads, dtype=torch.float32) * (
        2.0 * math.pi / n_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], dim=-1)  # [H, 2]
    grid = grid / grid.abs().max(dim=-1, keepdim=True).values
    grid = grid[:, None, None, :].repeat(1, n_levels, n_points, 1)
    scale = torch.arange(1, n_points + 1,
                         dtype=torch.float32)[None, None, :, None]
    return (grid * scale).reshape(-1)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention over flattened multi-level tokens."""

    def __init__(self, d_model: int = 256, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        hlp = n_heads * n_levels * n_points
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, hlp * 2)
        self.attention_weights = nn.Linear(d_model, hlp)
        self.output_proj = nn.Linear(d_model, d_model)

    @torch.no_grad()
    def reset_sampling(self):
        """Zero kernels with the directional bias (layers.py:92-107)."""
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_(directional_offset_bias(
            self.n_heads, self.n_levels, self.n_points))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()

    def forward(
        self,
        query: torch.Tensor,  # [B, Lq, C]
        reference_points: torch.Tensor,  # [B, Lq, L, 2|4] normalized
        value_src: torch.Tensor,  # [B, S, C]
        spatial_shapes: Tuple[Tuple[int, int], ...],
        padding_mask: Optional[torch.Tensor] = None,  # [B, S] True = pad
    ) -> torch.Tensor:
        H, L, P = self.n_heads, self.n_levels, self.n_points
        D = self.d_model // H
        B, Lq, _ = query.shape
        S = value_src.shape[1]

        value = self.value_proj(value_src)
        if padding_mask is not None:
            value = value.masked_fill(padding_mask[..., None], 0.0)
        value = value.reshape(B, S, H, D)

        offsets = self.sampling_offsets(query).reshape(B, Lq, H, L, P, 2)
        attn = self.attention_weights(query).reshape(B, Lq, H, L * P)
        attn = attn.softmax(-1).reshape(B, Lq, H, L, P)

        if reference_points.shape[-1] == 2:
            # normalize offsets by each level's (W, H)
            wh = torch.tensor([(w, h) for h, w in spatial_shapes],
                              dtype=torch.float32, device=query.device)
            loc = (reference_points[:, :, None, :, None, :]
                   + offsets / wh[None, None, None, :, None, :])
        elif reference_points.shape[-1] == 4:
            loc = (reference_points[:, :, None, :, None, :2]
                   + offsets / P
                   * reference_points[:, :, None, :, None, 2:] * 0.5)
        else:
            raise ValueError(
                "reference_points last dim must be 2 or 4, got "
                f"{reference_points.shape[-1]}")

        out = msda.ms_deform_attn(
            value.contiguous(), spatial_shapes,
            loc.to(torch.float32).contiguous(),
            attn.to(torch.float32).contiguous())
        return self.output_proj(out)
