"""Normalization layers in a compute dtype (port of
datr_tpu/models/norms.py).

- `LayerNorm` / `GroupNorm`: flax's LayerNorm / GroupNorm(dtype=...) as
  flax 0.12 computes them (linen/normalization.py:_normalize): the input
  upcast to f32, statistics and normalization in f32, the result cast to
  the module's dtype. At f32 they are nn.LayerNorm / nn.GroupNorm.
- `FastLayerNorm` / `FastGroupNorm` (bf16 only, `fast_norm=True`):
  statistics accumulated in f32 straight from the bf16 input, the square
  taken in bf16 as jax.lax.square takes it, var = E[x^2] - E[x]^2 clipped
  at 0, normalized in f32, then scaled and shifted in bf16.

Parameters are f32 `weight` / `bias` in all four (flax's `scale` / `bias`),
so the fast and plain norms load the same trees. GroupNorm works on NCHW.
Plain PyTorch: datr_tpu computes these in XLA, with no Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _widened(x: torch.Tensor) -> torch.Tensor:
    """x in at least f32, as flax takes a norm's statistics (f64 stays
    f64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class LayerNorm(nn.LayerNorm):
    """flax LayerNorm(dtype=dtype) semantics over the last dim."""

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=eps)
        self.dtype = dtype

    def forward(self, x):
        x = _widened(x)
        return F.layer_norm(x, self.normalized_shape,
                            self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps).to(self.dtype)


class GroupNorm(nn.GroupNorm):
    """flax GroupNorm(dtype=dtype) semantics, NCHW."""

    def __init__(self, num_groups: int, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_groups, features, eps=eps)
        self.dtype = dtype

    def forward(self, x):
        x = _widened(x)
        return F.group_norm(x, self.num_groups, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps).to(self.dtype)


def _moments(x: torch.Tensor, dims):
    """f32-accumulated mean and variance over `dims` of a bf16 x, the
    square rounded to bf16 (datr_tpu/models/norms.py:_moments)."""
    mean = x.mean(dims, keepdim=True, dtype=torch.float32)
    mean2 = (x * x).mean(dims, keepdim=True, dtype=torch.float32)
    return mean, (mean2 - mean * mean).clamp(min=0.0)


class FastLayerNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean, var = _moments(x, -1)
        y = (x.float() - mean) * torch.rsqrt(var + self.eps)
        return (y.to(self.dtype) * self.weight.to(self.dtype)
                + self.bias.to(self.dtype))


class FastGroupNorm(nn.Module):
    """NCHW; statistics over each group's channels and all pixels."""

    def __init__(self, num_groups: int, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        B, C = x.shape[:2]
        xg = x.reshape(B, self.num_groups, C // self.num_groups, -1)
        mean, var = _moments(xg, (2, 3))
        y = ((xg.float() - mean) * torch.rsqrt(var + self.eps)).reshape(
            x.shape)
        shape = (1, C) + (1,) * (x.dim() - 2)
        return (y.to(self.dtype) * self.weight.to(self.dtype).reshape(shape)
                + self.bias.to(self.dtype).reshape(shape))


def layer_norm(features: int, dtype: torch.dtype = torch.float32,
               fast: bool = False, eps: float = 1e-5) -> nn.Module:
    if fast and dtype == torch.bfloat16:
        return FastLayerNorm(features, eps, dtype)
    return LayerNorm(features, eps, dtype)


def group_norm(features: int, dtype: torch.dtype = torch.float32,
               fast: bool = False, num_groups: int = 32,
               eps: float = 1e-5) -> nn.Module:
    if fast and dtype == torch.bfloat16:
        return FastGroupNorm(num_groups, features, eps, dtype)
    return GroupNorm(num_groups, features, eps, dtype)
