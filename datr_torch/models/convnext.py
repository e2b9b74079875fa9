"""ConvNeXt backbone (port of datr_tpu/models/convnext.py).

A 4x4 patchify stem, stages of depthwise-7x7 + pointwise-MLP blocks with
LayerScale, LayerNorm + 2x2 convolution downsampling between stages, a
LayerNorm on each returned stage. Channels-last [B, H, W, C] inside, as
datr_tpu; the returned stage features are NCHW [B, C, h, w] views.
Attribute names mirror the flax tree (`stem_conv`, `down{s}_norm`,
`stage{s}_block{b}.dwconv`, `out_norm{s}`, ...).

datr_tpu's semantics, kept on purpose: `stem_conv` and `down{s}_conv` use
flax's "SAME" padding (an odd stage rounds its size up); every LayerNorm
has eps 1e-6; GELU is the tanh form. `gamma` is an f32 parameter that is
never cast: in bf16, `shortcut + gamma * x` promotes to f32, so the
residual stream is f32 after each block and the next depthwise convolution
casts it back to bf16, as in datr_tpu. Plain PyTorch: datr_tpu computes
these with XLA ops, no Pallas kernel.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from .layers import Conv2d, Linear, gelu, same_pad
from .norms import LayerNorm

LAYER_SCALE_INIT = 1e-6  # gamma's init (flax's layer_scale_init)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 7, padding=3, groups=dim, dtype=dtype)
        self.norm = LayerNorm(dim, 1e-6, dtype)
        self.pwconv1 = Linear(dim, 4 * dim, dtype=dtype)
        self.pwconv2 = Linear(4 * dim, dim, dtype=dtype)
        self.gamma = nn.Parameter(torch.full((dim,), LAYER_SCALE_INIT))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dwconv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        y = self.pwconv2(gelu(self.pwconv1(self.norm(y))))
        return x + self.gamma * y


class ConvNeXt(nn.Module):
    """Images [B, H, W, 3] -> the NCHW features of `return_stages` (0 =
    stride 4 ... 3 = stride 32). `widths`: each stage's channels."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 return_stages: Sequence[int] = (1, 2, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depths = tuple(depths)
        self.return_stages = tuple(return_stages)
        self.widths = tuple(dims)
        self.stem_conv = Conv2d(3, dims[0], 4, stride=4, dtype=dtype)
        self.stem_norm = LayerNorm(dims[0], 1e-6, dtype)
        for s, (depth, dim) in enumerate(zip(depths, dims)):
            if s > 0:
                self.add_module(f"down{s}_norm",
                                LayerNorm(dims[s - 1], 1e-6, dtype))
                self.add_module(f"down{s}_conv", Conv2d(
                    dims[s - 1], dim, 2, stride=2, dtype=dtype))
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}",
                                ConvNeXtBlock(dim, dtype=dtype))
            if s in self.return_stages:
                self.add_module(f"out_norm{s}", LayerNorm(dim, 1e-6, dtype))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.stem_conv(same_pad(x.permute(0, 3, 1, 2), 4, 4))
        x = self.stem_norm(x.permute(0, 2, 3, 1))
        outs = []
        for s, depth in enumerate(self.depths):
            if s > 0:
                x = getattr(self, f"down{s}_norm")(x).permute(0, 3, 1, 2)
                x = getattr(self, f"down{s}_conv")(same_pad(x, 2, 2))
                x = x.permute(0, 2, 3, 1)
            for b in range(depth):
                x = getattr(self, f"stage{s}_block{b}")(x)
            if s in self.return_stages:
                outs.append(getattr(self, f"out_norm{s}")(x)
                            .permute(0, 3, 1, 2))
        return tuple(outs)


CONVNEXT_CONFIGS = {
    "convnext_tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "convnext_small": dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    "convnext_base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    "convnext_large": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
    "convnext_xlarge_22k": dict(depths=(3, 3, 27, 3),
                                dims=(256, 512, 1024, 2048)),
}
