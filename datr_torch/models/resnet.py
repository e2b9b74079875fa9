"""ResNet-50/101 trunk with frozen batch-norm (port of
datr_tpu/models/resnet.py:21-111).

Takes images channels-last [B, H, W, 3] like the JAX package and runs NCHW
inside; the returned stage features are NCHW [B, C, h, w]. The convolutions
compute in `dtype`; frozen BN returns f32 (datr_tpu/models/resnet.py:35), so
each block's output and the stage features are f32 and the next
convolution casts again.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d


class FrozenBatchNorm(nn.Module):
    """y = (x - mean) / sqrt(var + eps) * weight + bias, stats frozen, f32."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    @torch.no_grad()
    def reset(self):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        return ((x.to(torch.float32) - self.running_mean[:, None, None])
                * scale[:, None, None] + self.bias[:, None, None])


def _conv(cin, cout, k, stride=1, padding=0, dilation=1,
          dtype=torch.float32):
    return Conv2d(cin, cout, k, stride=stride, padding=padding,
                  dilation=dilation, bias=False, dtype=dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with identity/projection shortcut."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dilation: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = _conv(in_features, features, 1, dtype=dtype)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = _conv(features, features, 3, strides, dilation, dilation,
                           dtype=dtype)
        self.bn2 = FrozenBatchNorm(features)
        self.conv3 = _conv(features, features * 4, 1, dtype=dtype)
        self.bn3 = FrozenBatchNorm(features * 4)
        self.has_downsample = in_features != features * 4 or strides != 1
        if self.has_downsample:
            self.downsample_conv = _conv(in_features, features * 4, 1, strides,
                                         dtype=dtype)
            self.downsample_bn = FrozenBatchNorm(features * 4)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """return_stages: 0 = layer1 (stride 4) ... 3 = layer4 (stride 32)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 return_stages: Sequence[int] = (1, 2, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.return_stages = tuple(return_stages)
        self.stage_sizes = tuple(stage_sizes)
        self.widths = (256, 512, 1024, 2048)  # stage 0..3 output widths
        self.conv1 = _conv(3, 64, 7, stride=2, padding=3, dtype=dtype)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for stage, (blocks, width) in enumerate(
                zip(stage_sizes, (64, 128, 256, 512))):
            for b in range(blocks):
                strides = 2 if (b == 0 and stage > 0) else 1
                self.add_module(f"layer{stage + 1}_block{b}",
                                Bottleneck(cin, width, strides, dtype=dtype))
                cin = width * 4

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x [B, H, W, 3] -> NCHW features of the requested stages."""
        y = x.permute(0, 3, 1, 2).contiguous()
        y = F.relu(self.bn1(self.conv1(y)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        outs = []
        for stage, blocks in enumerate(self.stage_sizes):
            for b in range(blocks):
                y = getattr(self, f"layer{stage + 1}_block{b}")(y)
            if stage in self.return_stages:
                outs.append(y)
        return tuple(outs)
