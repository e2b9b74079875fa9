"""Set criterion: matched detection losses, DN losses and the DA losses,
and the target-domain losses of self-training against pseudo-labels (port
of datr_tpu/train/criterion.py), with the same loss keys.

A bf16 model's outputs are upcast where datr_tpu upcasts them
(criterion.py:74,81,100,128-134,188-195,226): the focal loss, the matched
and DN boxes, the prototype BCE and the matcher's costs take f32; the
image discriminator's BCE stays in the logits' dtype, as there.

With instance masks (`gt_masks` [B, T, h4, w4] soft targets and the
outputs' `pred_masks`), the final layer adds `loss_mask` / `loss_dice` on
the final layer's assignment (datr_tpu/train/criterion.py:274-313; the
reference skips the aux and encoder layers' masks).

Targets have static shapes: boxes [B, T, 4] normalized cxcywh, labels [B, T]
int, valid [B, T] bool. `num_boxes` is the valid-target count of the global
batch, clipped at 1 (datr_tpu/train/criterion.py:289): across ranks the
count is all-reduced, clipped, then divided by the number of ranks, so that
the ranks' gradients averaged (DDP, FSDP) are the global batch's. The
assignments of every decoder layer and of the encoder output are solved
together (`ops.matcher.match_many`: one device-to-host copy of the costs per
call of `criterion`; a self-training step makes two calls, source and
target).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..models.segmentation import loss_masks
from ..ops.focal import sigmoid_ce, sigmoid_focal_loss
from ..parallel import dist as pdist
from ..ops.matcher import detr_matching_cost, match_many, minsum_match
from ..utils.boxes import box_cxcywh_to_xyxy, generalized_box_iou_elementwise


class CriterionCfg(NamedTuple):
    num_classes: int
    focal_alpha: float = 0.25
    cost_class: float = 2.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    dn_single_pad: int = 20
    dn_groups: int = 5
    matcher_type: str = "HungarianMatcher"  # or "SimpleMinsumMatcher"


def _gather_queries(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, C], idx [B, T] -> [B, T, C]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def detection_losses(
    logits: torch.Tensor,  # [B, N, K]
    boxes: torch.Tensor,  # [B, N, 4]
    gt_labels: torch.Tensor,  # [B, T]
    gt_boxes: torch.Tensor,  # [B, T, 4]
    gt_valid: torch.Tensor,  # [B, T]
    assign: torch.Tensor,  # [B, T] matched query per target
    num_boxes: torch.Tensor,  # scalar
    focal_alpha: float,
    img_mask: Optional[torch.Tensor] = None,  # [B]: 0 drops a whole image
) -> Dict[str, torch.Tensor]:
    B, N, K = logits.shape
    if img_mask is not None:
        # the reference drops images without pseudo-labels from the target
        # loss (self_training_utils.py:103-137)
        gt_valid = gt_valid & (img_mask > 0)[:, None]
    valid_f = gt_valid.to(torch.float32)
    assign_safe = torch.where(gt_valid, assign, 0)
    b_idx = torch.arange(B, device=logits.device)[:, None].expand_as(
        assign_safe)

    # labels: focal loss over all queries, matched ones get their class
    onehot_t = F.one_hot(gt_labels.long(), K).to(torch.float32) \
        * valid_f[..., None]
    target_onehot = torch.zeros((B, N, K), dtype=torch.float32,
                                device=logits.device)
    target_onehot.index_put_((b_idx, assign_safe), onehot_t, accumulate=True)
    focal = sigmoid_focal_loss(logits.float(), target_onehot, focal_alpha)
    if img_mask is not None:
        focal = focal * img_mask[:, None, None]
    loss_ce = focal.sum() / num_boxes

    # boxes: L1 + GIoU over matched pairs
    src_boxes = _gather_queries(boxes, assign_safe).float()  # [B, T, 4]
    l1 = (src_boxes - gt_boxes).abs() * valid_f[..., None]
    loss_bbox = l1.sum() / num_boxes
    giou = generalized_box_iou_elementwise(box_cxcywh_to_xyxy(src_boxes),
                                           box_cxcywh_to_xyxy(gt_boxes))
    loss_giou = ((1.0 - giou) * valid_f).sum() / num_boxes

    # logging only
    with torch.no_grad():
        matched = _gather_queries(logits, assign_safe)
        correct = (matched.argmax(-1) == gt_labels) & gt_valid
        denom = valid_f.sum().clamp(min=1.0)
        class_error = 100.0 * (1.0 - correct.sum() / denom)
        # predictions whose argmax is not the last class (reference quirk)
        card_pred = (logits.argmax(-1) != K - 1).sum(1)
        card_err = (card_pred.to(torch.float32) - valid_f.sum(-1)).abs().mean()
        loss_xy = l1[..., :2].sum() / num_boxes
        loss_hw = l1[..., 2:].sum() / num_boxes
    return {
        "loss_ce": loss_ce,
        "loss_bbox": loss_bbox,
        "loss_giou": loss_giou,
        "loss_xy": loss_xy,
        "loss_hw": loss_hw,
        "class_error": class_error,
        "cardinality_error": card_err,
    }


def compute_assign(preds, gt_labels, gt_boxes, gt_valid,
                   cfg: CriterionCfg) -> List[torch.Tensor]:
    """Matching only: the assignment [B, T] (query per target) of each
    (logits, boxes) in `preds`, every set solved in one pass."""
    if cfg.matcher_type == "SimpleMinsumMatcher":
        return [minsum_match(detr_matching_cost(
            lg.detach().float(), bx.detach().float(), gt_labels, gt_boxes,
            gt_valid, cfg.cost_class, cfg.cost_bbox, cfg.cost_giou,
            cfg.focal_alpha)) for lg, bx in preds]
    return match_many(preds, gt_labels, gt_boxes, gt_valid,
                      cost_class=cfg.cost_class, cost_bbox=cfg.cost_bbox,
                      cost_giou=cfg.cost_giou, focal_alpha=cfg.focal_alpha)


def dn_losses(
    dn_logits: torch.Tensor,  # [B, pad, K]
    dn_boxes: torch.Tensor,  # [B, pad, 4]
    dn_valid: torch.Tensor,  # [B, pad]
    gt_labels: torch.Tensor,  # [B, T]
    gt_boxes: torch.Tensor,  # [B, T, 4]
    num_boxes: torch.Tensor,
    cfg: CriterionCfg,
) -> Dict[str, torch.Tensor]:
    """Losses of the positive DN slots against their own GT (fixed identity
    matching inside each group), normalized by num_boxes * groups."""
    B, pad, K = dn_logits.shape
    sp, groups = cfg.dn_single_pad, cfg.dn_groups
    slot = torch.arange(pad, device=dn_logits.device)
    is_pos = (slot // sp) % 2 == 0
    tgt_idx = slot % sp

    T = gt_labels.shape[1]
    if T >= sp:
        lab, box = gt_labels[:, :sp], gt_boxes[:, :sp]
    else:
        lab = F.pad(gt_labels, (0, sp - T))
        box = F.pad(gt_boxes, (0, 0, 0, sp - T))
    slot_labels = lab[:, tgt_idx]
    slot_boxes = box[:, tgt_idx]
    pos_f = (dn_valid & is_pos[None, :]).to(torch.float32)

    norm = num_boxes * groups
    target_onehot = F.one_hot(slot_labels.long(), K).to(torch.float32) \
        * pos_f[..., None]
    loss_ce = sigmoid_focal_loss(dn_logits.float(), target_onehot,
                                 cfg.focal_alpha).sum() / norm
    l1 = (dn_boxes.float() - slot_boxes).abs() * pos_f[..., None]
    giou = generalized_box_iou_elementwise(
        box_cxcywh_to_xyxy(dn_boxes.float()), box_cxcywh_to_xyxy(slot_boxes))
    return {
        "loss_ce_dn": loss_ce,
        "loss_bbox_dn": l1.sum() / norm,
        "loss_giou_dn": ((1.0 - giou) * pos_f).sum() / norm,
    }


def da_image_loss(da_backbone: torch.Tensor) -> torch.Tensor:
    """BCE: source half -> 0, target half -> 1."""
    B = da_backbone.shape[0]
    src, tgt = da_backbone[: B // 2], da_backbone[B // 2:]
    return (sigmoid_ce(src, torch.zeros_like(src)).mean()
            + sigmoid_ce(tgt, torch.ones_like(tgt)).mean())


def da_proto_loss(da_protos: torch.Tensor, class_map_source: torch.Tensor,
                  class_map_target: torch.Tensor) -> torch.Tensor:
    """Prototype adversarial BCE, masked by class presence."""
    K = class_map_source.shape[0]
    target = torch.cat([torch.zeros(K, 1), torch.ones(K, 1)]).to(
        da_protos.device)
    loss = sigmoid_ce(da_protos.float(), target)
    mask = torch.cat([class_map_source, class_map_target])[:, None]
    return (loss * mask).mean()


def da_contrast_loss(query_source, query_target, class_map_source,
                     class_map_target, global_proto) -> torch.Tensor:
    """Cross-entropy of the normalized prototypes against the normalized
    global prototypes with soft labels eye(K) * class_map. Normalization is
    x * rsqrt(|x|^2 + 1e-12), finite at the zero rows of absent classes."""

    def normalize(x):
        return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)

    g = normalize(global_proto.detach())
    K = g.shape[0]
    eye = torch.eye(K, device=g.device)

    def one_side(q, cmap):
        # bf16 prototypes meet the f32 global ones in f32, as JAX promotes
        logits = normalize(q).to(g.dtype) @ g.T
        label = eye * cmap
        return (-(label * F.log_softmax(logits, -1)).sum(-1)).mean()

    return one_side(query_source, class_map_source) + one_side(
        query_target, class_map_target)


def global_num_boxes(gt_valid: torch.Tensor) -> torch.Tensor:
    """The valid-target count of the global batch clipped at 1, divided
    by the number of ranks (a rank's share of the normaliser)."""
    n = pdist.all_reduce_sum(gt_valid.sum().to(torch.float32))
    return n.clamp(min=1.0) / pdist.process_count()


def criterion(outputs: Dict[str, torch.Tensor], gt_labels: torch.Tensor,
              gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
              cfg: CriterionCfg,
              num_boxes: Optional[torch.Tensor] = None,
              target_domain: bool = False,
              img_mask: Optional[torch.Tensor] = None,
              gt_masks: Optional[torch.Tensor] = None,
              ) -> Dict[str, torch.Tensor]:
    """Every loss of one domain's outputs: the final layer, the aux layers
    (`_{i}`), the encoder output (`_interm`), and for the source domain the
    DN losses of every layer and the three DA losses. `target_domain` reads
    the `*_target` outputs of a self-training forward against the
    pseudo-labels and skips DN and DA; `img_mask` [B] drops whole images
    (those without pseudo-labels), before `num_boxes` is counted.
    `gt_masks` [B, T, h4, w4] with the outputs' `pred_masks` adds the masks
    term of the final layer."""
    sfx = "_target" if target_domain else ""
    if img_mask is not None:
        gt_valid = gt_valid & (img_mask > 0)[:, None]
    if num_boxes is None:
        num_boxes = global_num_boxes(gt_valid)
    aux_logits = outputs["aux_logits" + sfx]
    aux_boxes = outputs["aux_boxes" + sfx]
    n_aux = aux_logits.shape[0]
    preds = ([(outputs["pred_logits" + sfx], outputs["pred_boxes" + sfx])]
             + [(aux_logits[i], aux_boxes[i]) for i in range(n_aux)]
             + [(outputs["interm_logits" + sfx],
                 outputs["interm_boxes" + sfx])])
    assigns = compute_assign(preds, gt_labels, gt_boxes, gt_valid, cfg)

    def losses_of(j):
        return detection_losses(*preds[j], gt_labels, gt_boxes, gt_valid,
                                assigns[j], num_boxes, cfg.focal_alpha,
                                img_mask)

    losses: Dict[str, torch.Tensor] = dict(losses_of(0))
    if gt_masks is not None and "pred_masks" + sfx in outputs:
        losses.update(loss_masks(outputs["pred_masks" + sfx], gt_masks,
                                 gt_valid, assigns[0], num_boxes))
    for i in range(n_aux):
        losses.update({f"{k}_{i}": v for k, v in losses_of(1 + i).items()})
    losses.update({f"{k}_interm": v for k, v in losses_of(1 + n_aux).items()})

    if target_domain:
        return losses
    if "dn_logits" in outputs:
        dn_logits, dn_boxes = outputs["dn_logits"], outputs["dn_boxes"]
        n_dec = dn_logits.shape[0]
        for i in range(n_dec):
            dn = dn_losses(dn_logits[i], dn_boxes[i], outputs["dn_valid"],
                           gt_labels, gt_boxes, num_boxes, cfg)
            sfx = "" if i == n_dec - 1 else f"_{i}"
            losses.update({k + sfx: v for k, v in dn.items()})

    if "da_backbone" in outputs:
        losses["loss_backbone_DA"] = da_image_loss(outputs["da_backbone"])
        losses["loss_proto_DA"] = da_proto_loss(
            outputs["da_protos"], outputs["da_class_map_source"],
            outputs["da_class_map_target"])
        losses["loss_global_proto_DA"] = da_contrast_loss(
            outputs["da_query_source"], outputs["da_query_target"],
            outputs["da_class_map_source"], outputs["da_class_map_target"],
            outputs["new_global_proto"])
    return losses


def build_weight_dict(
    dec_layers: int = 6,
    cls_loss_coef: float = 1.0,
    bbox_loss_coef: float = 5.0,
    giou_loss_coef: float = 2.0,
    da_backbone_loss_coef: float = 0.1,
    da_proto_loss_coef: float = 0.1,
    da_global_proto_coef: float = 0.1,
    interm_loss_coef: float = 1.0,
    no_interm_box_loss: bool = False,
    use_dn: bool = True,
    masks: bool = False,
    mask_loss_coef: float = 1.0,
    dice_loss_coef: float = 1.0,
) -> Dict[str, float]:
    """Loss weights (datr_tpu/train/criterion.py:369-411)."""
    w = {
        "loss_ce": cls_loss_coef,
        "loss_bbox": bbox_loss_coef,
        "loss_giou": giou_loss_coef,
    }
    if masks:
        w["loss_mask"] = mask_loss_coef
        w["loss_dice"] = dice_loss_coef
    base = dict(w)
    w["loss_backbone_DA"] = da_backbone_loss_coef
    w["loss_proto_DA"] = da_proto_loss_coef
    w["loss_global_proto_DA"] = da_global_proto_coef
    if use_dn:
        w["loss_ce_dn"] = cls_loss_coef
        w["loss_bbox_dn"] = bbox_loss_coef
        w["loss_giou_dn"] = giou_loss_coef
    clean = {k: v for k, v in w.items()
             if k.startswith("loss_") and not k.endswith("_DA")}
    for i in range(dec_layers - 1):
        w.update({f"{k}_{i}": v for k, v in clean.items()})
    interm_box = 0.0 if no_interm_box_loss else 1.0
    w["loss_ce_interm"] = base["loss_ce"] * interm_loss_coef
    w["loss_bbox_interm"] = base["loss_bbox"] * interm_loss_coef * interm_box
    w["loss_giou_interm"] = base["loss_giou"] * interm_loss_coef * interm_box
    return w


def weighted_total(losses: Dict[str, torch.Tensor],
                   weight_dict: Dict[str, float]) -> torch.Tensor:
    total = 0.0
    for k, v in losses.items():
        if k in weight_dict:
            total = total + weight_dict[k] * v
    return total


def criterion_from_config(cfg, model) -> tuple:
    """(CriterionCfg, weight_dict) of a config and its model, as datr_tpu's
    model entry builds them (datr_tpu/models/dino.py:680-719)."""
    from ..models.cdn import cdn_layout

    get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: getattr(
        cfg, k, d)
    groups, _ = cdn_layout(model.dn_number, model.dn_single_pad)
    ccfg = CriterionCfg(
        num_classes=model.num_classes,
        focal_alpha=get("focal_alpha", 0.25),
        cost_class=get("set_cost_class", 2.0),
        cost_bbox=get("set_cost_bbox", 5.0),
        cost_giou=get("set_cost_giou", 2.0),
        dn_single_pad=model.dn_single_pad,
        dn_groups=groups,
        matcher_type=get("matcher_type", "HungarianMatcher"),
    )
    weight_dict = build_weight_dict(
        dec_layers=model.dec_layers,
        cls_loss_coef=get("cls_loss_coef", 1.0),
        bbox_loss_coef=get("bbox_loss_coef", 5.0),
        giou_loss_coef=get("giou_loss_coef", 2.0),
        da_backbone_loss_coef=get("da_backbone_loss_coef", 0.1),
        da_proto_loss_coef=get("da_proto_loss_coef", 0.1),
        da_global_proto_coef=get("da_global_proto_coef", 0.1),
        interm_loss_coef=get("interm_loss_coef", 1.0),
        no_interm_box_loss=get("no_interm_box_loss", False),
        use_dn=get("use_dn", True),
        masks=get("masks", False),
        mask_loss_coef=get("mask_loss_coef", 1.0),
        dice_loss_coef=get("dice_loss_coef", 1.0),
    )
    # scales the target-domain loss of a self-training step
    # (train/steps.py:self_training_loss_and_grads)
    weight_dict["loss_self_training"] = get("self_training_loss_coef", 1.0)
    return ccfg, weight_dict
