"""The DATR burn-in loss and update in plain PyTorch: Hungarian matching
(scipy), focal / L1 / GIoU losses of the final, auxiliary and encoder
outputs, the CDN losses, the three domain-adaptation losses, the weighted
total, the global-norm clip and AdamW over the trainable parameters
(DINO, DATR; AdamW as Loshchilov & Hutter, decoupled decay)."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from .model import box_cxcywh_to_xyxy


def _pairwise_giou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """xyxy [..., N, 4] x [..., M, 4] -> GIoU [..., N, M]."""
    def area(x):
        return ((x[..., 2] - x[..., 0]).clamp(min=0)
                * (x[..., 3] - x[..., 1]).clamp(min=0))

    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    iou = inter / union.clamp(min=1e-8)
    lt = torch.minimum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.maximum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / hull.clamp(min=1e-8)


def _giou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Aligned xyxy boxes [..., 4] -> GIoU [...]."""
    return _pairwise_giou(a[..., None, :], b[..., None, :])[..., 0, 0]


def sigmoid_ce(x, t):
    return x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def focal(x, t, alpha=0.25, gamma=2.0):
    p = x.sigmoid()
    p_t = p * t + (1 - p) * (1 - t)
    return (alpha * t + (1 - alpha) * (1 - t)) * sigmoid_ce(x, t) * (
        1 - p_t) ** gamma


def hungarian(logits, boxes, labels, gt_boxes, valid, w_cls=2.0, w_box=5.0,
              w_giou=2.0, alpha=0.25) -> torch.Tensor:
    """[B, T] prediction matched to each valid target (0 elsewhere)."""
    prob = logits.detach().float().sigmoid()
    pos = alpha * (1 - prob) ** 2 * -torch.log(prob + 1e-8)
    neg = (1 - alpha) * prob ** 2 * -torch.log(1 - prob + 1e-8)
    lab = labels.long()[:, None, :].expand(-1, prob.shape[1], -1)
    c_cls = torch.gather(pos - neg, -1, lab)  # [B, N, T]
    bx = boxes.detach().float()
    c_box = (bx[:, :, None, :] - gt_boxes[:, None, :, :]).abs().sum(-1)
    c_giou = -_pairwise_giou(box_cxcywh_to_xyxy(bx),
                             box_cxcywh_to_xyxy(gt_boxes))
    cost = (w_box * c_box + w_cls * c_cls + w_giou * c_giou).transpose(1, 2)
    cost = cost.cpu().numpy()
    v = valid.cpu().numpy()
    out = np.zeros(v.shape, np.int64)
    for b in range(v.shape[0]):
        rows = np.flatnonzero(v[b])
        if rows.size:
            r, c = linear_sum_assignment(cost[b][rows])
            out[b, rows[r]] = c
    return torch.from_numpy(out).to(logits.device)


def det_losses(logits, boxes, labels, gt_boxes, valid, assign, n, alpha):
    B, N, K = logits.shape
    vf = valid.float()
    a = torch.where(valid, assign, 0)
    onehot = torch.zeros((B, N, K), device=logits.device)
    bi = torch.arange(B, device=logits.device)[:, None].expand_as(a)
    onehot.index_put_((bi, a), F.one_hot(labels.long(), K).float()
                      * vf[..., None], accumulate=True)
    src = torch.gather(boxes, 1, a[..., None].expand(-1, -1, 4)).float()
    giou = _giou(box_cxcywh_to_xyxy(src), box_cxcywh_to_xyxy(gt_boxes))
    return {"loss_ce": focal(logits.float(), onehot, alpha).sum() / n,
            "loss_bbox": ((src - gt_boxes).abs() * vf[..., None]).sum() / n,
            "loss_giou": ((1 - giou) * vf).sum() / n}


def burnin_losses(out, labels, gt_boxes, valid, cfg) -> Dict[str, torch.Tensor]:
    """Every weighted loss term of a burn-in forward; keys as the measured
    package names them."""
    alpha = cfg["focal_alpha"]
    n = valid.sum().float().clamp(min=1.0)
    preds = ([(out["pred_logits"], out["pred_boxes"], "")]
             + [(out["aux_logits"][i], out["aux_boxes"][i], f"_{i}")
                for i in range(out["aux_logits"].shape[0])]
             + [(out["interm_logits"], out["interm_boxes"], "_interm")])
    losses = {}
    for lg, bx, sfx in preds:
        assign = hungarian(lg, bx, labels, gt_boxes, valid, cfg["set_cost_class"],
                           cfg["set_cost_bbox"], cfg["set_cost_giou"], alpha)
        for k, v in det_losses(lg, bx, labels, gt_boxes, valid, assign, n,
                               alpha).items():
            losses[k + sfx] = v
    # CDN: positive slots against their own target, fixed matching
    dn_logits, dn_boxes, dn_valid = (out["dn_logits"], out["dn_boxes"],
                                     out["dn_valid"])
    sp, groups = cfg["dn_single_pad"], cfg["dn_groups"]
    pad = dn_logits.shape[2]
    slot = torch.arange(pad, device=dn_logits.device)
    T = labels.shape[1]
    lab = F.pad(labels, (0, max(0, sp - T)))[:, :sp][:, slot % sp]
    box = F.pad(gt_boxes, (0, 0, 0, max(0, sp - T)))[:, :sp][:, slot % sp]
    pos = (dn_valid & ((slot // sp) % 2 == 0)[None]).float()
    norm = n * groups
    K = dn_logits.shape[-1]
    onehot = F.one_hot(lab.long(), K).float() * pos[..., None]
    n_dec = dn_logits.shape[0]
    for i in range(n_dec):
        sfx = "" if i == n_dec - 1 else f"_{i}"
        lg, bx = dn_logits[i].float(), dn_boxes[i].float()
        giou = _giou(box_cxcywh_to_xyxy(bx), box_cxcywh_to_xyxy(box))
        losses["loss_ce_dn" + sfx] = focal(lg, onehot, alpha).sum() / norm
        losses["loss_bbox_dn" + sfx] = ((bx - box).abs()
                                        * pos[..., None]).sum() / norm
        losses["loss_giou_dn" + sfx] = ((1 - giou) * pos).sum() / norm
    # domain adaptation
    d = out["da_backbone"]
    h = d.shape[0] // 2
    losses["loss_backbone_DA"] = (sigmoid_ce(d[:h], torch.zeros_like(d[:h]))
                                  .mean() + sigmoid_ce(
                                      d[h:], torch.ones_like(d[h:])).mean())
    cms, cmt = out["da_class_map_source"], out["da_class_map_target"]
    K = cms.shape[0]
    tgt = torch.cat([torch.zeros(K, 1), torch.ones(K, 1)]).to(d.device)
    losses["loss_proto_DA"] = (sigmoid_ce(out["da_protos"].float(), tgt)
                               * torch.cat([cms, cmt])[:, None]).mean()

    def unit(x):
        return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)

    g = unit(out["new_global_proto"].detach())
    eye = torch.eye(K, device=g.device)

    def contrast(q, cm):
        return (-(eye * cm * F.log_softmax(unit(q) @ g.T, -1)).sum(-1)).mean()

    losses["loss_global_proto_DA"] = (contrast(out["da_query_source"], cms)
                                      + contrast(out["da_query_target"], cmt))
    return losses


def weight_dict(cfg, dec_layers: int) -> Dict[str, float]:
    """The loss weights of DINO with DATR's DA terms."""
    base = {"loss_ce": cfg["cls_loss_coef"], "loss_bbox": cfg["bbox_loss_coef"],
            "loss_giou": cfg["giou_loss_coef"]}
    w = dict(base)
    w.update(loss_backbone_DA=cfg["da_backbone_loss_coef"],
             loss_proto_DA=cfg["da_proto_loss_coef"],
             loss_global_proto_DA=cfg["da_global_proto_coef"])
    w.update({k + "_dn": v for k, v in base.items()})
    clean = {k: v for k, v in w.items() if not k.endswith("_DA")}
    for i in range(dec_layers - 1):
        w.update({f"{k}_{i}": v for k, v in clean.items()})
    w.update({k + "_interm": v * cfg["interm_loss_coef"]
              for k, v in base.items()})
    return w


def total_loss(losses, weights) -> torch.Tensor:
    return sum(weights[k] * v for k, v in losses.items() if k in weights)


def is_frozen(name: str) -> bool:
    """The backbone's stem, its first stage and every frozen BN take no
    update (DINO freezes them in its ResNet backbone)."""
    keys = name.split(".")
    if keys[0] != "backbone":
        return False
    if keys[1] in ("conv1", "bn1") or keys[1].startswith("layer1_"):
        return True
    return keys[-2].startswith(("bn", "downsample_bn"))


class AdamW:
    """Global-norm clip of the trainable gradients, then AdamW (b1 0.9,
    b2 0.999, eps 1e-8, decoupled decay), lr by group (backbone / rest)."""

    def __init__(self, named_params, lr, lr_backbone, weight_decay, clip):
        self.params = [(n, p) for n, p in named_params if not is_frozen(n)]
        self.lr = {n: (lr_backbone if n.startswith("backbone.") else lr)
                   for n, _ in self.params}
        self.wd, self.clip, self.t = weight_decay, clip, 0
        self.m = {n: torch.zeros_like(p) for n, p in self.params}
        self.v = {n: torch.zeros_like(p) for n, p in self.params}

    @torch.no_grad()
    def clipped_grads(self) -> Dict[str, torch.Tensor]:
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in self.params}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = 1.0 if norm < self.clip else float(self.clip / norm)
        return {n: g * scale for n, g in grads.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]):
        self.t += 1
        b1, b2 = 0.9, 0.999
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for n, p in self.params:
            g, lr = grads[n], self.lr[n]
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.mul_(1 - lr * self.wd)
            p.sub_(lr / c1 * self.m[n] / (self.v[n].sqrt() / math.sqrt(c2)
                                          + 1e-8))


def leaf_names(model) -> List[str]:
    return [n for n, _ in model.named_parameters() if not is_frozen(n)]
