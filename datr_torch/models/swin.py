"""Swin Transformer backbone (port of datr_tpu/models/swin.py).

Patch embed, shifted-window attention with a relative position bias, patch
merging between stages, a LayerNorm on each returned stage. Channels-last
[B, H, W, C] inside, as datr_tpu; the returned stage features are NCHW
[B, C, h, w] views, as the port's ResNet returns them. Attribute names
mirror the flax tree (`patch_embed`, `stage{s}_block{b}.attn.qkv`,
`merge{s}.reduction`, `out_norm{s}`, ...).

datr_tpu's semantics, kept on purpose:
- the window is not shrunk for a stage smaller than it, and the odd blocks
  shift whatever the stage's size: a stage is zero-padded to a multiple of
  the window after `norm1`, the shift mask is built on the padded extent,
  and the padded tokens take part in unshifted windows without a mask;
- `patch_embed` is flax's Conv with "SAME" padding (the low side gets
  total // 2), and `PatchMerging` pads an odd side at the bottom / right;
- GELU is flax's default, the tanh form; every LayerNorm has eps 1e-5
  (`fast_norm` does not reach the backbone);
- in bf16 the attention logits are the f32 product of the bf16 q (scaled in
  bf16) and k, the f32 bias and mask are added in f32, the softmax is f32
  and cast to bf16, and the second product is summed in f32 and cast once
  (datr_tpu's `preferred_element_type=jnp.float32`). The bf16 operands are
  upcast and multiplied in f32, which is exact for a product of two bf16
  values.
Plain PyTorch: datr_tpu computes these with XLA ops, no Pallas kernel.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, Linear, gelu, in_dtype, same_pad
from .norms import LayerNorm


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nH*nW, ws*ws, C] (H, W divisible by ws), batch
    major."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(windows: torch.Tensor, ws: int, B: int, H: int,
                   W: int) -> torch.Tensor:
    C = windows.shape[-1]
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


@functools.lru_cache(maxsize=None)
def relative_position_index(ws: int) -> np.ndarray:
    """[ws*ws, ws*ws] rows of the bias table (datr_tpu/models/swin.py:
    39-45)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + np.array([ws - 1, ws - 1])
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


@functools.lru_cache(maxsize=None)
def shift_attn_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """Additive mask [n_windows, N, N] of a shifted layout (-100 between
    tokens of different regions), for one image of padded extent H x W
    (datr_tpu/models/swin.py:87-104)."""
    img = np.zeros((1, H, W, 1))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wslice in (slice(0, -ws), slice(-ws, -shift),
                       slice(-shift, None)):
            img[:, hs, wslice, :] = cnt
            cnt += 1
    win = (img.reshape(1, H // ws, ws, W // ws, ws, 1)
           .transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, 1))[:, :, 0]
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


_MASKS: Dict[Tuple, torch.Tensor] = {}


def _shift_mask(H: int, W: int, ws: int, shift: int,
                device: torch.device) -> torch.Tensor:
    """`shift_attn_mask` on `device`, copied there once per layout."""
    key = (H, W, ws, shift, str(device))
    if key not in _MASKS:
        _MASKS[key] = torch.from_numpy(
            shift_attn_mask(H, W, ws, shift)).to(device)
    return _MASKS[key]


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.window_size, self.dtype = (num_heads,
                                                        window_size, dtype)
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.proj = Linear(dim, dim, dtype=dtype)
        self.register_buffer("bias_index", torch.from_numpy(
            relative_position_index(window_size).reshape(-1)),
            persistent=False)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """x [nW, N, C]; mask [n_groups, N, N] additive (f32) or None."""
        nW, N, C = x.shape
        h = self.num_heads
        hd = C // h
        qkv = self.qkv(x).reshape(nW, N, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)  # [nW, h, N, hd], the compute dtype
        q = q * in_dtype(hd ** -0.5, q.dtype)
        attn = torch.matmul(q.float(), k.float().transpose(-2, -1))
        bias = self.relative_position_bias_table[self.bias_index]
        attn = attn + bias.reshape(N, N, h).permute(2, 0, 1)
        if mask is not None:
            g = mask.shape[0]
            attn = (attn.reshape(nW // g, g, h, N, N)
                    + mask[None, :, None]).reshape(nW, h, N, N)
        attn = attn.softmax(-1).to(self.dtype)
        out = torch.matmul(attn.float(), v.float())  # [nW, h, N, hd]
        out = out.transpose(1, 2).reshape(nW, N, C).to(self.dtype)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.norm1 = LayerNorm(dim, 1e-5, dtype)
        self.attn = WindowAttention(dim, num_heads, window_size, dtype)
        self.norm2 = LayerNorm(dim, 1e-5, dtype)
        self.mlp_fc1 = Linear(dim, 4 * dim, dtype=dtype)  # mlp_ratio 4
        self.mlp_fc2 = Linear(4 * dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        ws, shift = self.window_size, self.shift
        shortcut = x
        x = self.norm1(x)
        pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        Hp, Wp = H + pad_h, W + pad_w
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = _shift_mask(Hp, Wp, ws, shift, x.device)
        x = window_reverse(self.attn(window_partition(x, ws), mask), ws, B,
                           Hp, Wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x[:, :H, :W]
        y = self.mlp_fc2(gelu(self.mlp_fc1(self.norm2(x))))
        return x + y


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = LayerNorm(4 * dim, 1e-5, dtype)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[1:3]
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    """Images [B, H, W, 3] -> the NCHW features of `return_stages` (0 =
    stride 4 ... 3 = stride 32). `widths`: each stage's channels."""

    def __init__(self, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7,
                 return_stages: Sequence[int] = (1, 2, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depths = tuple(depths)
        self.return_stages = tuple(return_stages)
        self.widths = tuple(embed_dim * 2 ** s for s in range(len(depths)))
        self.patch_embed = Conv2d(3, embed_dim, 4, stride=4, dtype=dtype)
        self.patch_norm = LayerNorm(embed_dim, 1e-5, dtype)
        for s, depth in enumerate(self.depths):
            dim = self.widths[s]
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}", SwinBlock(
                    dim, num_heads[s], window_size,
                    shift=0 if b % 2 == 0 else window_size // 2,
                    dtype=dtype))
            if s in self.return_stages:
                self.add_module(f"out_norm{s}", LayerNorm(dim, 1e-5, dtype))
            if s < len(self.depths) - 1:
                self.add_module(f"merge{s}", PatchMerging(dim, dtype))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.patch_embed(same_pad(x.permute(0, 3, 1, 2), 4, 4))
        x = self.patch_norm(x.permute(0, 2, 3, 1))
        outs = []
        for s, depth in enumerate(self.depths):
            for b in range(depth):
                x = getattr(self, f"stage{s}_block{b}")(x)
            if s in self.return_stages:
                outs.append(getattr(self, f"out_norm{s}")(x)
                            .permute(0, 3, 1, 2))
            if s < len(self.depths) - 1:
                x = getattr(self, f"merge{s}")(x)
        return tuple(outs)


SWIN_CONFIGS = {
    "swin_T_224_1k": dict(embed_dim=96, depths=(2, 2, 6, 2),
                          num_heads=(3, 6, 12, 24)),
    "swin_S_224_1k": dict(embed_dim=96, depths=(2, 2, 18, 2),
                          num_heads=(3, 6, 12, 24)),
    "swin_B_384_22k": dict(embed_dim=128, depths=(2, 2, 18, 2),
                           num_heads=(4, 8, 16, 32), window_size=12),
    "swin_L_384_22k": dict(embed_dim=192, depths=(2, 2, 18, 2),
                           num_heads=(6, 12, 24, 48), window_size=12),
}
