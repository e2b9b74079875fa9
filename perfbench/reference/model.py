"""The DINO detector with DATR's domain-adaptation heads, in plain f32
PyTorch: a ResNet-50 or Swin backbone, four-scale input projections, six
deformable encoder layers, the two-stage top-k, six deformable decoder
layers with iterative box refinement and contrastive denoising (CDN)
queries, the image discriminator behind gradient reversal and the class
prototypes (DINO: arXiv 2203.03605; DATR: arXiv 2405.11765).

Attribute names follow the measured package's parameter tree, so one state
dict loads into both. Departures from the papers' code, all shared with the
measured package: no dropout, a static CDN layout of `dn_single_pad` slots a
group, flax's "SAME" padding of Swin's patch embedding and datr's window
handling of stages smaller than a window.

`select`: the two-stage top-k of the decoder's queries is a discrete
choice that f32 rounding reorders between near-tied proposals; a caller
that checks another implementation passes that implementation's choice
here, and the forward returns `select_gap`, how far that choice lies from
this reference's own ranking (0 when it is the same): the larger of the
widest gap between the two choices' scores rank by rank, and, taken as
sets, the widest distance from the k-th score of a member of this top-k
that the choice leaves out or of an outsider that it takes. Near-tied
proposals that trade places read round-off; a proposal chosen or dropped
far from the boundary reads its distance from it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .msda import ms_deform_attn

# ---------------------------------------------------------------- helpers


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def _sine(coord: torch.Tensor, dim_t: torch.Tensor) -> torch.Tensor:
    p = coord[..., None] / dim_t
    return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()],
                       dim=-1).reshape(*p.shape[:-1], dim_t.shape[0])


def sine_embed_for_position(pos: torch.Tensor, num_feats: int = 128):
    """[..., 4] (x, y, w, h) -> [..., 4 * num_feats] ordered (y, x, w, h)."""
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=pos.device)
    dim_t = 10000.0 ** (2.0 * torch.floor(dim_t / 2.0) / num_feats)
    emb = [_sine(pos[..., i] * (2.0 * math.pi), dim_t) for i in range(4)]
    return torch.cat([emb[1], emb[0], emb[2], emb[3]], dim=-1)


def position_embedding_sine(mask: torch.Tensor, num_pos_feats: int,
                            t_h: float, t_w: float) -> torch.Tensor:
    """mask [B, H, W] True = pad -> [B, H, W, 2 * num_pos_feats]."""
    not_mask = (~mask).to(torch.float32)
    y = not_mask.cumsum(1)
    x = not_mask.cumsum(2)
    y = y / (y[:, -1:, :] + 1e-6) * (2.0 * math.pi)
    x = x / (x[:, :, -1:] + 1e-6) * (2.0 * math.pi)
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=mask.device)
    expo = 2.0 * torch.floor(dim_t / 2.0) / num_pos_feats
    return torch.cat([_sine(y, t_h ** expo), _sine(x, t_w ** expo)], dim=-1)


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0],
                       dim=-1)


# ---------------------------------------------------------------- layers


class MLP(nn.Module):
    def __init__(self, in_dim, hidden_dim, out_dim, num_layers,
                 last_zero_init=False):
        super().__init__()
        self.num_layers, self.last_zero_init = num_layers, last_zero_init
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        for i in range(num_layers):
            self.add_module(f"layer{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


class MSDeformAttn(nn.Module):
    def __init__(self, d_model=256, n_levels=4, n_heads=8, n_points=4):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        hlp = n_heads * n_levels * n_points
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, hlp * 2)
        self.attention_weights = nn.Linear(d_model, hlp)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query, reference_points, value_src, spatial_shapes,
                padding_mask=None):
        H, L, P = self.n_heads, self.n_levels, self.n_points
        B, Lq, C = query.shape
        S = value_src.shape[1]
        value = self.value_proj(value_src)
        if padding_mask is not None:
            value = value.masked_fill(padding_mask[..., None], 0.0)
        value = value.reshape(B, S, H, C // H)
        offsets = self.sampling_offsets(query).reshape(B, Lq, H, L, P, 2)
        attn = self.attention_weights(query).reshape(B, Lq, H, L * P)
        attn = attn.softmax(-1).reshape(B, Lq, H, L, P)
        if reference_points.shape[-1] == 2:
            wh = torch.tensor([(w, h) for h, w in spatial_shapes],
                              dtype=torch.float32, device=query.device)
            loc = (reference_points[:, :, None, :, None, :]
                   + offsets / wh[None, None, None, :, None, :])
        else:
            loc = (reference_points[:, :, None, :, None, :2]
                   + offsets / P
                   * reference_points[:, :, None, :, None, 2:] * 0.5)
        return self.output_proj(ms_deform_attn(value, spatial_shapes, loc,
                                               attn))


class MultiheadAttention(nn.Module):
    """Dense attention, PyTorch's `in_proj_weight` / `out_proj` layout;
    attn_mask [N, N] bool, True = may attend."""

    def __init__(self, d_model, n_heads):
        super().__init__()
        self.n_heads = n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, attn_mask=None):
        B, N, C = q.shape
        H = self.n_heads
        d = C // H

        def heads(x, w, b):
            return F.linear(x, w, b).reshape(B, -1, H, d).transpose(1, 2)

        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q, k, v = heads(q, wq, bq), heads(k, wk, bk), heads(v, wv, bv)
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(d)
        if attn_mask is not None:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        o = logits.softmax(-1) @ v
        return self.out_proj(o.transpose(1, 2).reshape(B, N, C))


class FFN(nn.Module):
    def __init__(self, d_model, d_ffn):
        super().__init__()
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x):
        return self.norm(x + self.linear2(F.relu(self.linear1(x))))


class DeformableEncoderLayer(nn.Module):
    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.ffn = FFN(d_model, d_ffn)

    def forward(self, src, pos, ref, spatial_shapes, mask):
        out = self.self_attn(src + pos, ref, src, spatial_shapes, mask)
        return self.ffn(self.norm1(src + out))


class DeformableDecoderLayer(nn.Module):
    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, n_heads)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.ffn = FFN(d_model, d_ffn)

    def forward(self, tgt, query_pos, memory, ref, spatial_shapes, mask,
                self_attn_mask=None):
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt, self_attn_mask))
        ca = self.cross_attn(tgt + query_pos, ref, memory, spatial_shapes,
                             mask)
        return self.ffn(self.norm1(tgt + ca))


def encoder_reference_points(spatial_shapes, valid_ratios):
    dev = valid_ratios.device
    points = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
            torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
            indexing="ij")
        gy = gy.reshape(-1)[None] / (valid_ratios[:, None, lvl, 1] * h)
        gx = gx.reshape(-1)[None] / (valid_ratios[:, None, lvl, 0] * w)
        points.append(torch.stack([gx, gy], dim=-1))
    ref = torch.cat(points, dim=1)
    return ref[:, :, None, :] * valid_ratios[:, None, :, :]


def valid_ratios_from_mask(masks):
    out = []
    for m in masks:
        vh = (~m[:, :, 0]).sum(1).to(torch.float32) / m.shape[1]
        vw = (~m[:, 0, :]).sum(1).to(torch.float32) / m.shape[2]
        out.append(torch.stack([vw, vh], dim=-1))
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------- ResNet


class FrozenBatchNorm(nn.Module):
    def __init__(self, features, eps=1e-5):
        super().__init__()
        self.eps = eps
        for name, v in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                        ("running_var", 1.0)):
            self.register_buffer(name, torch.full((features,), v))

    def forward(self, x):
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        return ((x - self.running_mean[:, None, None]) * scale[:, None, None]
                + self.bias[:, None, None])


class Bottleneck(nn.Module):
    def __init__(self, cin, width, stride):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(width * 4)
        self.has_downsample = cin != width * 4 or stride != 1
        if self.has_downsample:
            self.downsample_conv = nn.Conv2d(cin, width * 4, 1, stride,
                                             bias=False)
            self.downsample_bn = FrozenBatchNorm(width * 4)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.has_downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + x)


class ResNet(nn.Module):
    def __init__(self, stage_sizes=(3, 4, 6, 3), return_stages=(1, 2, 3)):
        super().__init__()
        self.stage_sizes, self.return_stages = stage_sizes, return_stages
        self.widths = (256, 512, 1024, 2048)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for s, (n, width) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            for b in range(n):
                self.add_module(f"layer{s + 1}_block{b}", Bottleneck(
                    cin, width, 2 if (b == 0 and s > 0) else 1))
                cin = width * 4

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2).contiguous())))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        outs = []
        for s, n in enumerate(self.stage_sizes):
            for b in range(n):
                y = getattr(self, f"layer{s + 1}_block{b}")(y)
            if s in self.return_stages:
                outs.append(y)
        return outs


# ---------------------------------------------------------------- Swin

SWIN = {"swin_L_384_22k": dict(embed_dim=192, depths=(2, 2, 18, 2),
                               num_heads=(6, 12, 24, 48), window_size=12)}


def _relative_position_index(ws: int) -> torch.Tensor:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + (ws - 1)
    return torch.from_numpy((rel[..., 0] * (2 * ws - 1)
                             + rel[..., 1]).reshape(-1).astype(np.int64))


def _shift_mask(H, W, ws, shift, device) -> torch.Tensor:
    """[n_windows, N, N] additive mask of the shifted layout (-100 across
    regions)."""
    img = torch.zeros((H, W), device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(H // ws, ws, W // ws, ws).permute(0, 2, 1, 3).reshape(
        -1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim, num_heads, window_size):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None):
        nW, N, C = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(nW, N, 3, h, C // h).permute(
            2, 0, 3, 1, 4).unbind(0)
        attn = (q * (C // h) ** -0.5) @ k.transpose(-2, -1)
        idx = _relative_position_index(self.window_size).to(x.device)
        attn = attn + self.relative_position_bias_table[idx].reshape(
            N, N, h).permute(2, 0, 1)
        if mask is not None:
            g = mask.shape[0]
            attn = (attn.reshape(nW // g, g, h, N, N)
                    + mask[None, :, None]).reshape(nW, h, N, N)
        out = attn.softmax(-1) @ v
        return self.proj(out.transpose(1, 2).reshape(nW, N, C))


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, window_size, shift):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, 4 * dim)
        self.mlp_fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        B, H, W, C = x.shape
        ws, shift = self.window_size, self.shift
        y = self.norm1(x)
        ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
        y = F.pad(y, (0, 0, 0, pw, 0, ph))
        Hp, Wp = H + ph, W + pw
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = _shift_mask(Hp, Wp, ws, shift, x.device)
        win = y.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(
            0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)
        y = self.attn(win, mask).reshape(B, Hp // ws, Wp // ws, ws, ws,
                                         C).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(B, Hp, Wp, C)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y[:, :H, :W]
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)),
                                       approximate="tanh"))


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        H, W = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    def __init__(self, embed_dim, depths, num_heads, window_size,
                 return_stages=(1, 2, 3)):
        super().__init__()
        self.depths, self.return_stages = tuple(depths), tuple(return_stages)
        self.widths = tuple(embed_dim * 2 ** s for s in range(len(depths)))
        self.patch_embed = nn.Conv2d(3, embed_dim, 4, stride=4)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=1e-5)
        for s, depth in enumerate(self.depths):
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}", SwinBlock(
                    self.widths[s], num_heads[s], window_size,
                    0 if b % 2 == 0 else window_size // 2))
            if s in self.return_stages:
                self.add_module(f"out_norm{s}",
                                nn.LayerNorm(self.widths[s], eps=1e-5))
            if s < len(self.depths) - 1:
                self.add_module(f"merge{s}", PatchMerging(self.widths[s]))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        pads = []
        for size in (x.shape[3], x.shape[2]):  # "SAME", k = s = 4
            total = max((-(-size // 4) - 1) * 4 + 4 - size, 0)
            pads += [total // 2, total - total // 2]
        x = self.patch_norm(self.patch_embed(F.pad(x, pads)).permute(
            0, 2, 3, 1))
        outs = []
        for s, depth in enumerate(self.depths):
            for b in range(depth):
                x = getattr(self, f"stage{s}_block{b}")(x)
            if s in self.return_stages:
                outs.append(getattr(self, f"out_norm{s}")(x).permute(
                    0, 3, 1, 2))
            if s < len(self.depths) - 1:
                x = getattr(self, f"merge{s}")(x)
        return outs


# ---------------------------------------------------------------- DA parts


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -g


class ImageDiscriminator(nn.Module):
    def __init__(self, in_ch, ndf1=256, ndf2=128):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, ndf1, 3, padding=1)
        self.conv2 = nn.Conv2d(ndf1, ndf2, 3, padding=1)
        self.conv3 = nn.Conv2d(ndf2, ndf2, 3, padding=1)
        self.classifier = nn.Conv2d(ndf2, 1, 3, padding=1)

    def forward(self, x):
        for c in (self.conv1, self.conv2, self.conv3):
            x = F.leaky_relu(c(x), 0.2)
        return self.classifier(x)


def class_prototypes(queries, logits, global_proto, amount):
    """Per-class mean of the queries by argmax class, and the count-weighted
    update of the running prototypes."""
    B, N, C = queries.shape
    K = logits.shape[-1]
    q = queries.reshape(B * N, C)
    onehot = F.one_hot(logits.sigmoid().argmax(-1).reshape(-1), K).to(q.dtype)
    count = onehot.sum(0)
    protos = (onehot.T @ q) / torch.where(count == 0, 1.0, count)[:, None]
    with torch.no_grad():
        w = torch.where(count == 0, 0.0, count / (count + amount))[:, None]
        new_global = global_proto * (1.0 - w) + protos * w
    return protos, (count != 0).to(q.dtype), new_global, amount + count


# ---------------------------------------------------------------- CDN


class CdnDraws(NamedTuple):
    flip: torch.Tensor
    cls: torch.Tensor
    sign: torch.Tensor
    part: torch.Tensor


def draw_cdn(generator: torch.Generator, batch, groups, single_pad,
             num_classes, device) -> CdnDraws:
    """The step's CDN noise from a CPU generator, in the measured package's
    order of draws: label flips, new classes, box signs, box magnitudes."""
    shape = (batch, groups, 2, single_pad)
    flip = torch.rand(shape, generator=generator)
    cls = torch.randint(0, num_classes, shape, generator=generator)
    sign = torch.randint(0, 2, (*shape, 4), generator=generator)
    part = torch.rand((*shape, 4), generator=generator)
    return CdnDraws(*(t.to(device) for t in (flip, cls, sign, part)))


def cdn_queries(d: CdnDraws, boxes, labels, valid, label_table, sp, groups,
                label_noise_ratio, box_noise_scale):
    """Noised label embeddings, unsigmoided noised boxes and slot validity,
    [B, 2 * sp * groups, ...], group g = sp positives then sp negatives."""
    B, T = labels.shape
    if T >= sp:
        boxes, labels, valid = boxes[:, :sp], labels[:, :sp], valid[:, :sp]
    else:
        boxes = F.pad(boxes, (0, 0, 0, sp - T))
        labels, valid = F.pad(labels, (0, sp - T)), F.pad(valid, (0, sp - T))
    pad = 2 * sp * groups
    bt = boxes[:, None, None].expand(B, groups, 2, sp, 4)
    lt = labels[:, None, None].expand(B, groups, 2, sp)
    vt = valid[:, None, None].expand(B, groups, 2, sp)
    new_labels = torch.where(d.flip < label_noise_ratio * 0.5,
                             d.cls.to(lt.dtype), lt).reshape(B, pad).long()
    half = torch.cat([bt[..., 2:] / 2.0] * 2, dim=-1)
    part = d.part + torch.tensor([0.0, 1.0], device=boxes.device)[
        None, None, :, None, None]
    noised = (box_cxcywh_to_xyxy(bt) + (d.sign.to(torch.float32) * 2.0 - 1.0)
              * part * half * box_noise_scale)
    noised = box_xyxy_to_cxcywh(noised.clamp(0.0, 1.0)).reshape(B, pad, 4)
    slot_valid = vt.reshape(B, pad)
    embed = torch.where(slot_valid[..., None], label_table[new_labels], 0.0)
    unsig = torch.where(slot_valid[..., None], inverse_sigmoid(noised), 0.0)
    return embed, unsig, slot_valid


def cdn_attn_mask(num_queries, sp, groups, device):
    pad = 2 * sp * groups
    allow = torch.ones((pad + num_queries,) * 2, dtype=torch.bool,
                       device=device)
    allow[pad:, :pad] = False
    for g in range(groups):
        lo, hi = 2 * sp * g, 2 * sp * (g + 1)
        allow[lo:hi, :lo] = False
        allow[lo:hi, hi:pad] = False
    return allow


# ---------------------------------------------------------------- DINO


class DINO(nn.Module):
    def __init__(self, num_classes=9, num_queries=900, hidden_dim=256,
                 nheads=8, enc_layers=6, dec_layers=6, dim_feedforward=2048,
                 num_feature_levels=4, enc_n_points=4, dec_n_points=4,
                 backbone="resnet50", pe_temperature_h=20.0,
                 pe_temperature_w=20.0, return_interm_indices=(1, 2, 3),
                 dn_number=100, dn_single_pad=20, dn_label_noise_ratio=0.5,
                 dn_box_noise_scale=0.4, dn_labelbook_size=None,
                 use_remat=False):
        super().__init__()
        C = hidden_dim
        self.num_classes, self.num_queries, self.hidden_dim = (
            num_classes, num_queries, hidden_dim)
        self.enc_layers, self.dec_layers = enc_layers, dec_layers
        self.num_feature_levels = num_feature_levels
        self.pe = (float(pe_temperature_h), float(pe_temperature_w))
        self.return_interm_indices = tuple(return_interm_indices)
        self.dn_single_pad = dn_single_pad
        self.dn_groups = max(1, dn_number // max(1, dn_single_pad))
        self.dn_number = dn_number
        self.dn_label_noise_ratio = dn_label_noise_ratio
        self.dn_box_noise_scale = dn_box_noise_scale
        self.use_remat = use_remat
        if backbone == "resnet50":
            self.backbone = ResNet((3, 4, 6, 3), self.return_interm_indices)
        elif backbone == "resnet_tiny":  # the CPU tests' one block a stage
            self.backbone = ResNet((1, 1, 1, 1), self.return_interm_indices)
        else:
            self.backbone = SwinTransformer(
                **SWIN[backbone], return_stages=self.return_interm_indices)
        in_chs = [self.backbone.widths[s] for s in self.return_interm_indices]
        for i in range(num_feature_levels):
            if i < len(in_chs):
                conv = nn.Conv2d(in_chs[i], C, 1)
            else:
                cin = in_chs[-1] if i == len(in_chs) else C
                conv = nn.Conv2d(cin, C, 3, stride=2, padding=1)
            self.add_module(f"input_proj{i}_conv", conv)
            self.add_module(f"input_proj{i}_norm", nn.GroupNorm(32, C, 1e-5))
        self.level_embed = nn.Parameter(torch.empty(num_feature_levels, C))
        for i in range(enc_layers):
            self.add_module(f"enc_layer{i}", DeformableEncoderLayer(
                C, dim_feedforward, num_feature_levels, nheads, enc_n_points))
        for i in range(dec_layers):
            self.add_module(f"dec_layer{i}", DeformableDecoderLayer(
                C, dim_feedforward, num_feature_levels, nheads, dec_n_points))
        self.decoder_norm = nn.LayerNorm(C, eps=1e-5)
        self.ref_point_head = MLP(2 * C, C, C, 2)
        self.class_head = nn.Linear(C, num_classes)
        self.bbox_head = MLP(C, C, 4, 3, last_zero_init=True)
        self.enc_out_class_head = nn.Linear(C, num_classes)
        self.enc_out_bbox_head = MLP(C, C, 4, 3, last_zero_init=True)
        self.enc_output = nn.Linear(C, C)
        self.enc_output_norm = nn.LayerNorm(C, eps=1e-5)
        self.tgt_embed = nn.Parameter(torch.empty(num_queries, C))
        book = num_classes if dn_labelbook_size is None else dn_labelbook_size
        self.label_enc = nn.Parameter(torch.empty(book + 1, C))
        self.d_img = ImageDiscriminator(C)
        self.proto_d = MLP(C, C, 1, 3)

    # -------------------------------------------------------------- parts
    def _features(self, images, pad_mask):
        feats = self.backbone(images)
        srcs, masks, poss = [], [], []
        for lvl in range(self.num_feature_levels):
            x = feats[lvl] if lvl < len(feats) else (
                feats[-1] if lvl == len(feats) else srcs[-1])
            s = getattr(self, f"input_proj{lvl}_norm")(
                getattr(self, f"input_proj{lvl}_conv")(x))
            m = F.interpolate(pad_mask[:, None].float(), size=s.shape[-2:],
                              mode="nearest-exact")[:, 0].bool()
            srcs.append(s)
            masks.append(m)
            poss.append(position_embedding_sine(m, self.hidden_dim // 2,
                                                *self.pe))
        B = images.shape[0]
        shapes = tuple((int(s.shape[2]), int(s.shape[3])) for s in srcs)
        src = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        mask = torch.cat([m.reshape(B, -1) for m in masks], 1)
        pos = torch.cat([p.reshape(B, -1, p.shape[-1]) + self.level_embed[i]
                         for i, p in enumerate(poss)], 1)
        return srcs, src, mask, pos, shapes, valid_ratios_from_mask(masks)

    def _remat(self, layer, *args):
        if self.use_remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(layer, *args,
                                                     use_reentrant=False)
        return layer(*args)

    def _select(self, memory, mask, shapes, select):
        B, dev = memory.shape[0], memory.device
        props, off = [], 0
        for lvl, (h, w) in enumerate(shapes):
            m = mask[:, off:off + h * w].reshape(B, h, w)
            off += h * w
            vh = (~m[:, :, 0]).sum(1).float()
            vw = (~m[:, 0, :]).sum(1).float()
            gy, gx = torch.meshgrid(torch.arange(h, device=dev).float(),
                                    torch.arange(w, device=dev).float(),
                                    indexing="ij")
            grid = torch.stack([gx, gy], -1).reshape(1, h * w, 2)
            centers = (grid + 0.5) / torch.stack([vw, vh], -1)[:, None]
            props.append(torch.cat([centers, torch.full_like(
                centers, 0.05 * 2.0 ** lvl)], -1))
        props = torch.cat(props, 1)
        ok = ((props > 0.01) & (props < 0.99)).all(-1) & ~mask
        out_memory = self.enc_output_norm(self.enc_output(
            memory.masked_fill(~ok[..., None], 0.0)))
        unsig = torch.where(ok[..., None], inverse_sigmoid(props),
                            torch.full_like(props, 1e6))
        enc_class = self.enc_out_class_head(out_memory)
        coord = self.enc_out_bbox_head(out_memory) + unsig
        scores = enc_class.max(-1).values.detach()
        order = torch.sort(scores, dim=-1, descending=True, stable=True).indices[
            :, :self.num_queries]
        gap = torch.zeros((), device=dev)
        if select is None:
            select = order
        else:  # another implementation's choice, held to this ranking
            select = select.to(dev).long()
            gap = (torch.gather(scores, 1, select)
                   - torch.gather(scores, 1, order)).abs().max()
            # and as a set: a member of this top-k left out, or an outsider
            # taken, reads how far its score lies from the k-th
            kth = torch.gather(scores, 1, order[:, -1:])
            mine = torch.zeros_like(scores, dtype=torch.bool).scatter_(
                1, order, True)
            theirs = torch.zeros_like(mine).scatter_(1, select, True)
            left = (scores - kth).masked_fill(~(mine & ~theirs), 0.0)
            taken = (kth - scores).masked_fill(~(theirs & ~mine), 0.0)
            gap = torch.maximum(gap, torch.maximum(left.amax(),
                                                   taken.amax()))

        def rows(x):
            return torch.gather(x, 1, select[..., None].expand(
                -1, -1, x.shape[-1]))

        return (rows(coord), rows(out_memory), rows(unsig).sigmoid(), gap,
                select)

    def _transformer(self, src, mask, pos, shapes, vr, select=None,
                     dn_embed=None, dn_unsig=None, attn_mask=None):
        B = src.shape[0]
        ref_enc = encoder_reference_points(shapes, vr)
        memory = src
        for i in range(self.enc_layers):
            memory = self._remat(getattr(self, f"enc_layer{i}"), memory, pos,
                                 ref_enc, shapes, mask)
        ref_unsig_u, tgt_u, _, gap, chosen = self._select(memory, mask,
                                                          shapes, select)
        ref_unsig = ref_unsig_u.detach()
        x = self.tgt_embed[None].expand(B, -1, -1)
        if dn_embed is not None:
            x = torch.cat([dn_embed, x], 1)
            ref_unsig = torch.cat([dn_unsig, ref_unsig], 1)
        ref = ref_unsig.sigmoid()
        vr4 = torch.cat([vr, vr], -1)
        hs, refs = [], [ref]
        for i in range(self.dec_layers):
            ref_in = ref[:, :, None, :] * vr4[:, None]
            qpos = self.ref_point_head(sine_embed_for_position(
                ref_in[:, :, 0, :], self.hidden_dim // 2))
            x = self._remat(getattr(self, f"dec_layer{i}"), x, qpos, memory,
                            ref_in, shapes, mask, attn_mask)
            new_ref = (self.bbox_head(x) + inverse_sigmoid(ref)).sigmoid()
            refs.append(new_ref)
            ref = new_ref.detach()
            hs.append(self.decoder_norm(x))
        return (torch.stack(hs), torch.stack(refs), tgt_u, ref_unsig_u,
                (gap, chosen))

    def _heads(self, hs, refs):
        return self.class_head(hs), (self.bbox_head(hs)
                                     + inverse_sigmoid(refs[:-1])).sigmoid()

    # -------------------------------------------------------------- forward
    def forward(self, images, pad_mask, select=None):
        """Eval: images [B, H, W, 3] normalized, pad_mask [B, H, W] ->
        pred_logits [B, Q, K], pred_boxes [B, Q, 4] cxcywh, select_gap."""
        _, src, mask, pos, shapes, vr = self._features(images, pad_mask)
        hs, refs, _, _, (gap, chosen) = self._transformer(
            src, mask, pos, shapes, vr, select)
        logits, boxes = self._heads(hs[-1:], refs[-2:])
        return {"pred_logits": logits[0], "pred_boxes": boxes[0],
                "select_gap": gap, "chosen": chosen}

    def forward_train(self, images, pad_mask, targets, global_proto, amount,
                      draws: CdnDraws, select=(None, None)):
        """The DA burn-in forward: source half with CDN queries, the image
        discriminator over every level, the prototypes of both domains and
        the target pass. `select`: (source, target) choices."""
        srcs, src, mask, pos, shapes, vr = self._features(images, pad_mask)
        B = src.shape[0]
        half = B // 2
        sp, groups = self.dn_single_pad, self.dn_groups
        pad = 2 * sp * groups
        dn_embed, dn_unsig, dn_valid = cdn_queries(
            draws, targets["boxes"], targets["labels"], targets["valid"],
            self.label_enc, sp, groups, self.dn_label_noise_ratio,
            self.dn_box_noise_scale)
        attn_mask = cdn_attn_mask(self.num_queries, sp, groups, src.device)
        hs, refs, tgt_u, ref_u, (gap_s, ch_s) = self._transformer(
            src[:half], mask[:half], pos[:half], shapes, vr[:half],
            select[0], dn_embed, dn_unsig, attn_mask)
        logits_all, boxes_all = self._heads(hs, refs)
        out = {"dn_logits": logits_all[:, :, :pad],
               "dn_boxes": boxes_all[:, :, :pad], "dn_valid": dn_valid}
        logits, boxes = logits_all[:, :, pad:], boxes_all[:, :, pad:]
        out.update(pred_logits=logits[-1], pred_boxes=boxes[-1],
                   aux_logits=logits[:-1], aux_boxes=boxes[:-1],
                   interm_logits=self.enc_out_class_head(tgt_u),
                   interm_boxes=ref_u.sigmoid())
        out["da_backbone"] = torch.cat(
            [self.d_img(_GradReverse.apply(s)).reshape(B, -1, 1)
             for s in srcs], 1)
        p_src, cm_src, g1, a1 = class_prototypes(
            hs[-1][:, pad:], out["pred_logits"], global_proto, amount)
        hs_t, _, _, _, (gap_t, ch_t) = self._transformer(
            src[half:], mask[half:], pos[half:], shapes, vr[half:],
            select[1])
        p_tgt, cm_tgt, g2, a2 = class_prototypes(
            hs_t[-1], self.class_head(hs_t[-1]), g1, a1)
        out["da_protos"] = self.proto_d(_GradReverse.apply(
            torch.cat([p_src, p_tgt], 0)))
        out.update(da_class_map_source=cm_src, da_class_map_target=cm_tgt,
                   da_query_source=p_src, da_query_target=p_tgt,
                   new_global_proto=g2, new_amount=a2,
                   select_gap=torch.maximum(gap_s, gap_t),
                   chosen=(ch_s, ch_t))
        return out
