"""The instance-mask head (DETRsegm), its losses and the mask finishes
(port of datr_tpu/models/segmentation.py).

- `MHAttentionMap`: per-query multi-head attention maps against the
  stride-32 encoder memory; the softmax runs over heads and space jointly,
  in f32 in every dtype, with -inf on padded cells.
- `MaskHeadSmallConv`: 3x3 conv + GroupNorm(8) + ReLU blocks of widths
  [C + heads, C/2, C/4, C/8, C/16] merging the stride-16 / 8 / 4 backbone
  stages through 1x1 adapters, then `out_lay` to one logit map at stride
  4. NCHW. Its GroupNorms are flax's plain GroupNorm whatever `fast_norm`
  says, as datr_tpu builds them.
- `mask_head_forward`: the B x Q fan-out. The adapters run once per image
  and their outputs are gathered per (image, query) pair (a 1x1 conv
  commutes with the gather: datr_tpu gathers the raw stage and adapts each
  pair, the same function at twice the work). With `query_chunk` the pairs
  go through the head in chunks of at most that many, in (b, q) raster
  order, the chunk rounded down to a divisor of B * Q; with `remat` each
  chunk is recomputed in the backward, so training holds one chunk's
  activations at a time.
- The losses (`dice_loss`, `mask_focal_loss`, `loss_masks`) at the
  prediction's stride-4 grid against area-averaged soft targets.
- The host finish (`det_mask_rles`: numpy, as datr_tpu keeps it),
  `postprocess_segm` and `postprocess_panoptic`.

datr_tpu computes all of this outside any Pallas kernel (flax convs and
GroupNorms, jnp.einsum): here cuDNN convolutions and torch matmuls.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils.rle import encode_mask
from .layers import Conv2d, Linear
from .norms import GroupNorm

# ---------------------------------------------------------------------------
# resize helpers
# ---------------------------------------------------------------------------


def nearest_resize_torch(x: torch.Tensor, size: Tuple[int, int]
                         ) -> torch.Tensor:
    """torch's nearest index map src = floor(i * in / out) (the one
    datr_tpu mirrors for NHWC), on NCHW x."""
    return F.interpolate(x, size=tuple(size), mode="nearest")


def bilinear_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Half-pixel bilinear resize of the last two axes (align_corners=False,
    jax.image.resize 'linear'; a downscale antialiases as jax does)."""
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    y = x.reshape(-1, 1, h, w)
    down = size[0] < h or size[1] < w
    y = F.interpolate(y, size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=down)
    return y.reshape(*lead, *size)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class MHAttentionMap(nn.Module):
    """q [B, Q, C], k channels-last [B, h, w, C], mask [B, h, w] True =
    padded -> [B, Q, heads, h, w] f32 attention weights (no value mix)."""

    def __init__(self, hidden_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_dim, self.num_heads = hidden_dim, num_heads
        self.q_linear = Linear(hidden_dim, hidden_dim, dtype=dtype)
        # the reference's 1x1 conv, a Dense over channels-last k
        self.k_linear = Linear(hidden_dim, hidden_dim, dtype=dtype)

    def forward(self, q, k, mask: Optional[torch.Tensor] = None):
        B, Q, _ = q.shape
        h, w = k.shape[1], k.shape[2]
        nh = self.num_heads
        hd = self.hidden_dim // nh
        qh = self.q_linear(q).reshape(B, Q, nh, hd).float()
        kh = self.k_linear(k).reshape(B, h, w, nh, hd).float()
        logits = torch.einsum("bqnc,bhwnc->bqnhw",
                              qh * (float(hd) ** -0.5), kh)
        if mask is not None:
            logits = logits.masked_fill(mask[:, None, None], float("-inf"))
        weights = torch.softmax(logits.reshape(B, Q, nh * h * w), -1)
        return weights.reshape(B, Q, nh, h, w)


class MaskHeadSmallConv(nn.Module):
    """FPN-style conv mask head over one fused [N, dim, h, w] tensor (dim =
    context + heads channels, in that order) and the per-pair adapter
    outputs of three backbone stages at 2x-increasing resolution."""

    def __init__(self, dim: int, context_dim: int, fpn_dims: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = context_dim
        inter = [dim, c // 2, c // 4, c // 8, c // 16, c // 64]
        ins = [dim, dim, inter[1], inter[2], inter[3]]
        for i, (cin, ch) in enumerate(zip(ins, inter[:5]), start=1):
            self.add_module(f"lay{i}", Conv2d(cin, ch, 3, padding=1,
                                              dtype=dtype))
            self.add_module(f"gn{i}", GroupNorm(8, ch, 1e-5, dtype))
        for stage, fd in enumerate(fpn_dims, start=1):
            self.add_module(f"adapter{stage}",
                            Conv2d(fd, inter[stage], 1, dtype=dtype))
        self.out_lay = Conv2d(inter[4], 1, 3, padding=1, dtype=dtype)

    def _block(self, x, i):
        x = getattr(self, f"lay{i}")(x)
        return F.relu(getattr(self, f"gn{i}")(x))

    def laterals(self, fpns: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The three adapters on their per-image stages [C4, C3, C2]."""
        return [getattr(self, f"adapter{s + 1}")(f)
                for s, f in enumerate(fpns)]

    def forward(self, x: torch.Tensor, laterals: Sequence[torch.Tensor]
                ) -> torch.Tensor:
        """x [N, dim, h32, w32], laterals per pair -> [N, h4, w4] logits."""
        x = self._block(x, 1)
        x = self._block(x, 2)
        for stage, lat in enumerate(laterals):
            x = lat + nearest_resize_torch(x, lat.shape[-2:])
            x = self._block(x, 3 + stage)
        return self.out_lay(x)[:, 0]


def _divisor_chunk(query_chunk: int, n: int) -> int:
    """The largest divisor of n not above query_chunk (datr_tpu rounds
    down, so the bound on live pairs always holds)."""
    return next(c for c in range(query_chunk, 0, -1) if n % c == 0)


def mask_head_forward(attn_map_mod: MHAttentionMap,
                      mask_head_mod: MaskHeadSmallConv,
                      hs_last: torch.Tensor,     # [B, Q, C]
                      src_proj: torch.Tensor,    # [B, C, h32, w32]
                      memory_32: torch.Tensor,   # [B, h32, w32, C]
                      level_mask: torch.Tensor,  # [B, h32, w32] True = pad
                      fpns: Sequence[torch.Tensor],  # [C4, C3, C2] NCHW
                      query_chunk: int = 0,
                      remat: bool = False) -> torch.Tensor:
    """pred_masks [B, Q, h4, w4] stride-4 logits (datr_tpu/models/
    segmentation.py:143-194; see the module docstring for the chunks)."""
    B, Q, _ = hs_last.shape
    h, w = src_proj.shape[-2:]
    bbox_mask = attn_map_mod(hs_last, memory_32, level_mask)
    att = bbox_mask.reshape(B * Q, -1, h, w).to(src_proj.dtype)
    lats = mask_head_mod.laterals(fpns)
    img_idx = torch.arange(B * Q, device=hs_last.device) // Q

    def run(idx, att_i, src, *lat):
        fused = torch.cat([src[idx], att_i], 1)
        return mask_head_mod(fused, [t[idx] for t in lat])

    n = B * Q
    chunk = _divisor_chunk(query_chunk, n) if 0 < query_chunk < n else n
    outs = []
    for s in range(0, n, chunk):
        args = (img_idx[s:s + chunk], att[s:s + chunk], src_proj, *lats)
        if remat and torch.is_grad_enabled():
            outs.append(checkpoint(run, *args, use_reentrant=False))
        else:
            outs.append(run(*args))
    masks = torch.cat(outs, 0)
    return masks.reshape(B, Q, masks.shape[-2], masks.shape[-1])


# ---------------------------------------------------------------------------
# losses (datr_tpu/models/segmentation.py:205-277)
# ---------------------------------------------------------------------------


def dice_loss(inputs: torch.Tensor, targets: torch.Tensor,
              num_boxes: torch.Tensor,
              pair_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DICE / F-1 loss of logits [P, ...] against targets in [0, 1]; pairs
    with pair_valid False count 0."""
    P = inputs.shape[0]
    probs = inputs.float().sigmoid().reshape(P, -1)
    targets = targets.reshape(P, -1).float()
    if pair_valid is not None:
        v = pair_valid.float()[:, None]
        probs, targets = probs * v, targets * v
    num = 2.0 * (probs * targets).sum(-1)
    den = probs.sum(-1) + targets.sum(-1)
    loss = 1.0 - (num + 1.0) / (den + 1.0)
    if pair_valid is not None:
        loss = torch.where(pair_valid, loss, 0.0)
    return loss.sum() / num_boxes


def mask_focal_loss(inputs: torch.Tensor, targets: torch.Tensor,
                    num_boxes: torch.Tensor,
                    pair_valid: Optional[torch.Tensor] = None,
                    alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Sigmoid focal loss, mean over pixels, summed over pairs / num_boxes."""
    x, t = inputs.float(), targets.float()
    prob = x.sigmoid()
    ce = x.clamp(min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    p_t = prob * t + (1.0 - prob) * (1.0 - t)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * t + (1.0 - alpha) * (1.0 - t)) * loss
    loss = loss.reshape(inputs.shape[0], -1).mean(-1)
    if pair_valid is not None:
        loss = torch.where(pair_valid, loss, 0.0)
    return loss.sum() / num_boxes


def loss_masks(pred_masks: torch.Tensor,  # [B, N, h, w] logits
               gt_masks: torch.Tensor,    # [B, T, Hm, Wm] in [0, 1]
               gt_valid: torch.Tensor,    # [B, T]
               assign: torch.Tensor,      # [B, T] matched query per target
               num_boxes: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The criterion's masks term: the matched predictions, focal + dice,
    at the prediction's grid; resized (bilinear) only when the targets'
    grid differs."""
    B, T = gt_valid.shape
    h, w = pred_masks.shape[-2:]
    assign_safe = torch.where(gt_valid, assign, 0).long()
    src = torch.gather(pred_masks, 1,
                       assign_safe[:, :, None, None].expand(B, T, h, w))
    if src.shape[-2:] != gt_masks.shape[-2:]:
        src = bilinear_resize(src, tuple(gt_masks.shape[-2:]))
    src = src.reshape(B * T, -1)
    tgt = gt_masks.reshape(B * T, -1)
    pv = gt_valid.reshape(B * T)
    return {"loss_mask": mask_focal_loss(src, tgt, num_boxes, pv),
            "loss_dice": dice_loss(src, tgt, num_boxes, pv)}


# ---------------------------------------------------------------------------
# the host finish (numpy, datr_tpu/models/segmentation.py:280-333)
# ---------------------------------------------------------------------------


def _bilinear_np(x: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Half-pixel bilinear resize (align_corners=False) of [..., H, W]."""
    h, w = x.shape[-2], x.shape[-1]
    ys = np.clip((np.arange(oh) + 0.5) * (h / oh) - 0.5, 0, h - 1)
    xs = np.clip((np.arange(ow) + 0.5) * (w / ow) - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    a = x[..., y0[:, None], x0[None, :]]
    b = x[..., y0[:, None], x1[None, :]]
    c = x[..., y1[:, None], x0[None, :]]
    d = x[..., y1[:, None], x1[None, :]]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


def det_mask_rles(mask_logits: np.ndarray,  # [S, h4, w4] stride-4 logits
                  canvas_hw: Tuple[int, int],
                  real_hw: Tuple[int, int],  # unpadded (h, w) on the canvas
                  orig_hw: Tuple[int, int],  # original image (h, w)
                  chunk: int = 32) -> List[np.ndarray]:
    """Detection masks finished on the host: bilinear upsample of the
    stride-4 logits to the padded canvas, logit > 0 (probability > 0.5),
    the image's real region cropped, nearest resize to the original size,
    RLE counts; `chunk` detections at a time."""
    H, W = canvas_hw
    ih, iw = min(int(real_hw[0]), H), min(int(real_hw[1]), W)
    oh, ow = int(orig_hw[0]), int(orig_hw[1])
    yi = np.floor(np.arange(oh) * (ih / oh)).astype(np.int64)
    xi = np.floor(np.arange(ow) * (iw / ow)).astype(np.int64)
    out: List[np.ndarray] = []
    for s in range(0, mask_logits.shape[0], chunk):
        up = _bilinear_np(
            np.asarray(mask_logits[s:s + chunk], np.float32), H, W)
        binm = up[:, :ih, :iw] > 0.0
        binm = binm[:, yi[:, None], xi[None, :]]
        out.extend(encode_mask(m) for m in binm)
    return out


# ---------------------------------------------------------------------------
# postprocessors
# ---------------------------------------------------------------------------


def postprocess_segm(results: List[Dict[str, np.ndarray]],
                     pred_masks: torch.Tensor,  # [B, Q, h, w] logits
                     orig_target_sizes: np.ndarray,  # [B, 2] original (h, w)
                     max_target_sizes: np.ndarray,   # [B, 2] post-aug (h, w)
                     threshold: float = 0.5) -> List[Dict[str, np.ndarray]]:
    """The reference's PostProcessSegm: bilinear upsample to the batch's
    largest size (on the logits' device), sigmoid > threshold, each
    image's real region, nearest resize to its original size, as uint8
    `masks` in each result dict."""
    max_h = int(np.max(max_target_sizes[:, 0]))
    max_w = int(np.max(max_target_sizes[:, 1]))
    up = bilinear_resize(pred_masks.float(), (max_h, max_w))
    binm = (up.sigmoid() > threshold).cpu().numpy()
    for i, (t, tt) in enumerate(zip(max_target_sizes, orig_target_sizes)):
        ih, iw = int(t[0]), int(t[1])
        m = binm[i][:, :ih, :iw]
        oh, ow = int(tt[0]), int(tt[1])
        yi = np.floor(np.arange(oh) * (ih / oh)).astype(np.int64)
        xi = np.floor(np.arange(ow) * (iw / ow)).astype(np.int64)
        results[i]["masks"] = m[:, yi[:, None], xi[None, :]].astype(np.uint8)
    return results


def postprocess_panoptic(pred_logits: np.ndarray,  # [Q, K]
                         pred_masks,                 # [Q, h, w] logits
                         is_thing_map: Dict[int, bool],
                         processed_size: Tuple[int, int],
                         target_size: Optional[Tuple[int, int]] = None,
                         threshold: float = 0.85) -> Dict[str, np.ndarray]:
    """One image's panoptic assembly (reference segmentation.py:268-375):
    {'id_map': [H, W] int32 segment ids, 'segments_info': [...]}. The
    kept masks' bilinear resize runs on `pred_masks`' device (a numpy
    array: the CPU); the rest is numpy on the host."""
    if target_size is None:
        target_size = processed_size
    pred_logits = np.asarray(pred_logits)
    z = pred_logits - pred_logits.max(-1, keepdims=True)
    probs = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    scores, labels = probs.max(-1), probs.argmax(-1)
    keep = (labels != pred_logits.shape[-1] - 1) & (scores > threshold)
    cur_scores, cur_classes = scores[keep], labels[keep]
    pm = torch.as_tensor(pred_masks)
    kept = pm[torch.as_tensor(keep, device=pm.device)].float()
    cur_masks = bilinear_resize(kept, tuple(processed_size)).cpu().numpy()
    h, w = processed_size

    def assemble(masks):
        if masks.shape[0] == 0:
            return np.zeros((h, w), np.int32)
        return masks.reshape(masks.shape[0], -1).argmax(0).reshape(
            h, w).astype(np.int32)

    m_id = assemble(cur_masks)
    stuff: Dict[int, List[int]] = {}  # duplicate stuff segments merge
    for k, lab in enumerate(cur_classes):
        if not is_thing_map.get(int(lab), True):
            stuff.setdefault(int(lab), []).append(k)
    for ids in stuff.values():
        for eq in ids[1:]:
            m_id[m_id == eq] = ids[0]

    th, tw = target_size
    yi = np.floor(np.arange(th) * (h / th)).astype(np.int64)
    xi = np.floor(np.arange(tw) * (w / tw)).astype(np.int64)
    m_id = m_id[yi[:, None], xi[None, :]]

    while cur_classes.size > 0:  # drop tiny segments, then reassemble
        area = np.array([(m_id == i).sum() for i in range(len(cur_scores))])
        small = area <= 4
        if not small.any():
            break
        keep2 = ~small
        cur_scores, cur_classes = cur_scores[keep2], cur_classes[keep2]
        cur_masks = cur_masks[keep2]
        m_id = assemble(cur_masks)
        m_id = m_id[yi[:, None], xi[None, :]]

    segments_info = [
        {"id": i, "isthing": bool(is_thing_map.get(int(c), True)),
         "category_id": int(c), "area": int((m_id == i).sum())}
        for i, c in enumerate(cur_classes)]
    return {"id_map": m_id, "segments_info": segments_info}
