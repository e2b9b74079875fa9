"""Domain-adaptation parts: gradient reversal, the image discriminator and
class prototypes (port of datr_tpu/models/da.py:20-92).

In bf16, `class_prototypes` builds its one-hot and class counts in the
queries' dtype, as datr_tpu does (da.py:80-83): a count above 256 is
rounded to bf16 there (the sum is taken in f32 and rounded once, in both),
and the port rounds it in the same place. The running state
(`global_proto`, `amount`) stays f32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -g


def grad_reverse(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; negates the gradient."""
    return _GradReverse.apply(x)


class ImageDiscriminator(nn.Module):
    """Patch-level domain discriminator: four 3x3 convolutions with leaky
    ReLU 0.2 between them. NCHW [B, C, h, w] -> [B, 1, h, w] logits."""

    def __init__(self, in_ch: int, ndf1: int = 256, ndf2: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_ch, ndf1, 3, padding=1, dtype=dtype)
        self.conv2 = Conv2d(ndf1, ndf2, 3, padding=1, dtype=dtype)
        self.conv3 = Conv2d(ndf2, ndf2, 3, padding=1, dtype=dtype)
        self.classifier = Conv2d(ndf2, 1, 3, padding=1, dtype=dtype)

    def forward(self, x):
        y = F.leaky_relu(self.conv1(x), 0.2)
        y = F.leaky_relu(self.conv2(y), 0.2)
        y = F.leaky_relu(self.conv3(y), 0.2)
        return self.classifier(y)


class PrototypeResult(NamedTuple):
    prototypes: torch.Tensor  # [K, C] batch prototypes
    valid_class_map: torch.Tensor  # [K] 1.0 where the class is present
    new_global_proto: torch.Tensor  # [K, C], no gradient
    new_amount: torch.Tensor  # [K]


def class_prototypes(queries: torch.Tensor, logits: torch.Tensor,
                     global_proto: torch.Tensor,
                     amount: torch.Tensor) -> PrototypeResult:
    """Per-class mean of the query features by argmax class, and the
    count-weighted momentum update of the running global prototypes.
    queries [B, N, C], logits [B, N, K], global_proto [K, C], amount [K]."""
    B, N, C = queries.shape
    K = logits.shape[-1]
    q = queries.reshape(B * N, C)
    pred = torch.sigmoid(logits).argmax(-1).reshape(B * N)
    onehot = F.one_hot(pred, K).to(q.dtype)  # [BN, K]
    class_count = onehot.sum(0)
    valid = (class_count != 0).to(q.dtype)
    denom = torch.where(class_count == 0, 1.0, class_count)
    protos = (onehot.T @ q) / denom[:, None]
    with torch.no_grad():
        weight = class_count / (class_count + amount)
        weight = torch.where(class_count == 0, 0.0, weight)[:, None]
        new_global = global_proto * (1.0 - weight) + protos * weight
    return PrototypeResult(protos, valid, new_global, amount + class_count)
