"""Contrastive denoising (CDN) queries with the static layout of datr_tpu
(port of datr_tpu/models/cdn.py:42-129).

  groups   = max(1, dn_number // single_pad)
  pad_size = 2 * single_pad * groups

Group g occupies slots [2g*single_pad, (2g+2)*single_pad): first half
positive (small jitter), second half negative (jitter in the 1..2 band).
Slots beyond an image's GT count are masked by `dn_valid`.

The noise is drawn from an explicit `torch.Generator` (`draw_cdn_noise`);
`build_cdn_queries` also takes the four draws as tensors, so a test can feed
it the draws jax.random made for datr_tpu.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils.boxes import box_cxcywh_to_xyxy, box_xyxy_to_cxcywh
from ..utils.misc import inverse_sigmoid


class CdnBatch(NamedTuple):
    query_label_embed: torch.Tensor  # [B, pad_size, C]
    query_bbox_unsig: torch.Tensor  # [B, pad_size, 4]
    dn_valid: torch.Tensor  # [B, pad_size] bool: the slot holds a real GT
    noised_labels: torch.Tensor  # [B, pad_size] int64


class CdnDraws(NamedTuple):
    """The random numbers of one `build_cdn_queries` call, in the order and
    shapes of datr_tpu's four jax.random draws (cdn.py:95-112)."""
    flip: torch.Tensor  # [B, G, 2, sp] uniform [0, 1)
    cls: torch.Tensor  # [B, G, 2, sp] int in [0, num_classes)
    sign: torch.Tensor  # [B, G, 2, sp, 4] int in {0, 1}
    part: torch.Tensor  # [B, G, 2, sp, 4] uniform [0, 1)


def cdn_layout(dn_number: int, single_pad: int) -> Tuple[int, int]:
    groups = max(1, dn_number // max(1, single_pad))
    return groups, 2 * single_pad * groups


def cdn_self_attn_mask(num_queries: int, single_pad: int, groups: int,
                       device=None) -> torch.Tensor:
    """[N, N] bool, True = may attend (scaled_dot_product_attention's bool
    convention), N = pad_size + num_queries. Matching queries see no DN
    slot; DN group g sees itself and the matching part."""
    pad_size = 2 * single_pad * groups
    n = pad_size + num_queries
    allow = torch.ones((n, n), dtype=torch.bool, device=device)
    allow[pad_size:, :pad_size] = False
    for g in range(groups):
        lo, hi = 2 * single_pad * g, 2 * single_pad * (g + 1)
        allow[lo:hi, :lo] = False
        allow[lo:hi, hi:pad_size] = False
    return allow


def draw_cdn_noise(generator: torch.Generator, batch: int, groups: int,
                   single_pad: int, num_classes: int, device) -> CdnDraws:
    """Fresh CDN noise from `generator`, moved to `device`."""
    shape = (batch, groups, 2, single_pad)
    flip = torch.rand(shape, generator=generator)
    cls = torch.randint(0, num_classes, shape, generator=generator)
    sign = torch.randint(0, 2, (*shape, 4), generator=generator)
    part = torch.rand((*shape, 4), generator=generator)
    return CdnDraws(*(t.to(device) for t in (flip, cls, sign, part)))


def build_cdn_queries(
    draws: CdnDraws,
    gt_boxes: torch.Tensor,  # [B, Nmax, 4] normalized cxcywh
    gt_labels: torch.Tensor,  # [B, Nmax] int
    gt_valid: torch.Tensor,  # [B, Nmax] bool
    label_embed_table: torch.Tensor,  # [labelbook_size + 1, C]
    dn_number: int = 100,
    single_pad: int = 20,
    label_noise_ratio: float = 0.5,
    box_noise_scale: float = 0.4,
) -> CdnBatch:
    B = gt_boxes.shape[0]
    groups, pad_size = cdn_layout(dn_number, single_pad)

    # cap / pad the GT to single_pad entries
    nmax = gt_boxes.shape[1]
    if nmax >= single_pad:
        boxes = gt_boxes[:, :single_pad]
        labels = gt_labels[:, :single_pad]
        valid = gt_valid[:, :single_pad]
    else:
        pad = single_pad - nmax
        boxes = torch.nn.functional.pad(gt_boxes, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(gt_labels, (0, pad))
        valid = torch.nn.functional.pad(gt_valid, (0, pad))

    # [B, groups, 2 (positive, negative), single_pad, ...]
    boxes_t = boxes[:, None, None].expand(B, groups, 2, single_pad, 4)
    labels_t = labels[:, None, None].expand(B, groups, 2, single_pad)
    valid_t = valid[:, None, None].expand(B, groups, 2, single_pad)

    # label noise: flip with probability ratio / 2 to a uniform class
    flip = draws.flip < label_noise_ratio * 0.5
    noised_labels = torch.where(flip, draws.cls.to(labels_t.dtype), labels_t)

    # box noise in corner space: positives jitter within the box extent,
    # negatives in the 1..2 band
    corners = box_cxcywh_to_xyxy(boxes_t)
    half_wh = torch.cat([boxes_t[..., 2:] / 2.0] * 2, dim=-1)
    sign = draws.sign.to(torch.float32) * 2.0 - 1.0
    is_neg = torch.tensor([0.0, 1.0], device=gt_boxes.device)
    part = draws.part + is_neg[None, None, :, None, None]
    noised = corners + sign * part * half_wh * box_noise_scale
    noised_boxes = box_xyxy_to_cxcywh(noised.clamp(0.0, 1.0))

    noised_labels = noised_labels.reshape(B, pad_size).long()
    noised_boxes = noised_boxes.reshape(B, pad_size, 4)
    dn_valid = valid_t.reshape(B, pad_size)

    embed = label_embed_table[noised_labels]
    embed = torch.where(dn_valid[..., None], embed, 0.0)
    bbox_unsig = torch.where(dn_valid[..., None],
                             inverse_sigmoid(noised_boxes), 0.0)
    return CdnBatch(embed, bbox_unsig, dn_valid, noised_labels)
