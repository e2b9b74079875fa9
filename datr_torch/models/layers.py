"""The compute-dtype Linear and Conv2d, the MLP head and the MSDeformAttn
module (port of datr_tpu/models/layers.py).

Attribute names mirror the flax parameter tree (`layer0`, `value_proj`,
`sampling_offsets`, ...) so converted weights load by a mechanical walk
(datr_torch/convert.py).

The compute dtype is explicit, as flax's `dtype=` is: parameters stay f32,
and a `Linear` / `Conv2d` casts its input, weight and bias to its `dtype`
and returns that dtype (the sum is f32 inside the product). As flax's
Dense / Conv do, it rounds the product to `dtype` and then adds the bias,
a second rounding in bf16 (the fused bias of F.linear / conv2d rounds once
and differs in about a quarter of the outputs by an ulp); in f32 the fused
add differs by at most an f32 rounding and stays. No autocast: autocast
would keep norms, softmax and reductions in f32 where datr_tpu computes
them in bf16. At f32 every cast is a no-op.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import msda


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """F.linear in `dtype` as flax's Dense computes it: the product rounded
    to `dtype`, then the bias added (see the module docstring)."""
    x, w = x.to(dtype), weight.to(dtype)
    if bias is None or dtype == torch.float32:
        return F.linear(x, w, bias)
    return F.linear(x, w) + bias.to(dtype)


class Linear(nn.Linear):
    """flax Dense(dtype=dtype): f32 parameters, computed in `dtype`.

    Under tensor parallelism (parallel/mesh.py `apply_tp`, `tp` the axis's
    collectives) a "column" layer holds its rank's output features and
    enters the TP region (`tp.copy`: its input's gradient is summed over
    the ranks); a "row" layer holds its rank's input features, sums the
    ranks' partial products (`tp.reduce`) and then adds its whole bias
    once."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias)
        self.dtype = dtype
        self.tp, self.tp_mode = None, None

    def forward(self, x):
        if self.tp is None:
            return linear(x, self.weight, self.bias, self.dtype)
        if self.tp_mode == "column":
            return linear(self.tp.copy(x), self.weight, self.bias,
                          self.dtype)
        y = self.tp.reduce(linear(x, self.weight, None, self.dtype))
        return y if self.bias is None else y + self.bias.to(self.dtype)


class Conv2d(nn.Conv2d):
    """flax Conv(dtype=dtype), NCHW: f32 parameters, computed in `dtype`."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x):
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if self.bias is None or self.dtype == torch.float32:
            return self._conv_forward(x, w, self.bias)
        return (self._conv_forward(x, w, None)
                + self.bias.to(self.dtype)[:, None, None])


class _RoundedSoftmax(torch.autograd.Function):
    """jax.nn.softmax's ops in the input's dtype, each rounded as XLA
    rounds it, and the VJP of its JVP rule (jax/_src/nn/functions.py,
    `_softmax` / `_softmax_jvp`)."""

    @staticmethod
    def forward(ctx, x):
        e = (x - x.amax(-1, keepdim=True)).exp()
        y = e / e.sum(-1, keepdim=True)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        yg = y * g
        return yg - y * yg.sum(-1, keepdim=True)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis as datr_tpu takes it: in bf16, each op
    rounds to bf16 (torch's fused softmax rounds once); in f32 the fused one
    differs by a few f32 roundings and stays."""
    if x.dtype == torch.float32:
        return x.softmax(-1)
    return _RoundedSoftmax.apply(x)


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """NCHW `x` padded as flax's "SAME" pads a k x k, stride-s convolution:
    the output is ceil(size / s), the low side gets total // 2."""
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad's order: last dim first
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def in_dtype(c: float, dtype: torch.dtype) -> float:
    """The Python constant `c` rounded to `dtype`: jax converts a Python
    scalar to the array's dtype before the op, torch computes with the
    scalar as given."""
    return torch.tensor(c, dtype=dtype).item()


_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's `nn.gelu`: jax.nn.gelu(approximate=True), the tanh form. In
    f32 the fused F.gelu; in bf16 jax's ops in bf16, each rounded
    (x * 0.5 (1 + tanh(sqrt(2/pi) (x + 0.044715 x (x x)))), its constants
    rounded to bf16 first), where F.gelu would round once."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    c = in_dtype(_SQRT_2_OVER_PI, x.dtype)
    cube = x * (x * x)  # lax.integer_pow's multiplications
    inner = c * (x + in_dtype(0.044715, x.dtype) * cube)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


class MLP(nn.Module):
    """ReLU MLP with layers `layer0` .. `layer{n-1}`."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int, last_zero_init: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.last_zero_init = last_zero_init
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        for i in range(num_layers):
            self.add_module(f"layer{i}", Linear(dims[i], dims[i + 1],
                                                dtype=dtype))

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
    """Multi-scale deformable attention over flattened multi-level tokens.
    In bf16 the value, offsets and attention logits are bf16 (the softmax
    too), the sampling locations f32: value bf16 and loc / attn f32 reach
    the MSDA op (datr_tpu/models/layers.py:85,131-134).

    Split over `tp_size` ranks (parallel/mesh.py `apply_tp`) a rank holds
    n_heads / tp_size heads: its value [B, S, H/tp, D], offsets and
    weights go through the same MSDA op, and `output_proj` sums the
    ranks' parts."""

    def __init__(self, d_model: int = 256, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.tp_size = 1
        hlp = n_heads * n_levels * n_points
        self.value_proj = Linear(d_model, d_model, dtype=dtype)
        self.sampling_offsets = Linear(d_model, hlp * 2, dtype=dtype)
        self.attention_weights = Linear(d_model, hlp, dtype=dtype)
        self.output_proj = Linear(d_model, d_model, dtype=dtype)

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
        H, L, P = self.n_heads // self.tp_size, self.n_levels, self.n_points
        D = self.d_model // self.n_heads
        B, Lq, _ = query.shape
        S = value_src.shape[1]

        value = self.value_proj(value_src)
        if padding_mask is not None:
            value = value.masked_fill(padding_mask[..., None], 0.0)
        value = value.reshape(B, S, H, D)

        offsets = self.sampling_offsets(query).reshape(B, Lq, H, L, P, 2)
        attn = self.attention_weights(query).reshape(B, Lq, H, L * P)
        attn = softmax(attn).reshape(B, Lq, H, L, P)

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
