"""DINO detection transformer with domain adaptation (port of
datr_tpu/models/dino.py).

Eval (dino.py:478-509): backbone -> input projections -> deformable encoder
layers -> two-stage top-k -> deformable decoder layers with iterative box
refinement -> shared heads.

Train (dino.py:511-629) takes a paired batch, first half source and second
half target: the source pass with CDN denoising queries split off the
outputs, the image discriminator behind gradient reversal over every level,
class prototypes of both domains, and the target pass without DN. With
`use_remat` each encoder and decoder layer is recomputed in the backward
(torch.utils.checkpoint). With `self_training` the target pass's own
detection outputs come back too (`*_target`). No masks.
Module attribute names mirror the flax parameter tree (`input_proj0_conv`,
`enc_layer3`, `class_head`, `d_img`, ...).

`dtype` (f32 or bf16, from the config's `amp_dtype`) is the compute dtype of
every Linear, Conv2d and norm; parameters stay f32. The casts are datr_tpu's
(dino.py:253,375,392,538): the position embeddings, the content queries, the
decoder's sine query embedding and the CDN label embeddings go to `dtype`;
frozen BN returns f32; the box refinement adds bf16 deltas to f32
`inverse_sigmoid` references, so references, boxes and the sampling
locations stay f32 while logits and hidden states are bf16. `fast_norm`
picks the fast bf16 norms (models/norms.py).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..utils.misc import inverse_sigmoid, sine_embed_for_position
from .cdn import (
    CdnDraws,
    build_cdn_queries,
    cdn_layout,
    cdn_self_attn_mask,
    draw_cdn_noise,
)
from .da import ImageDiscriminator, class_prototypes, grad_reverse
from .layers import MLP, Conv2d, Linear, MSDeformAttn
from .norms import FastGroupNorm, FastLayerNorm, group_norm, layer_norm
from .position_encoding import position_embedding_sine_hw
from .resnet import FrozenBatchNorm, ResNet
from .transformer import (
    DeformableDecoderLayer,
    DeformableEncoderLayer,
    MultiheadAttention,
    encoder_reference_points,
    valid_ratios_from_mask,
)

RESNET_STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
RESNET_CHANNELS = (256, 512, 1024, 2048)  # stage 0..3 output widths
AMP_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _stable_topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis; ties keep the lower
    index first, as jax.lax.top_k does."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, S, C], idx [B, K] -> [B, K, C]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


class DINO(nn.Module):
    def __init__(
        self,
        num_classes: int = 9,
        num_queries: int = 900,
        hidden_dim: int = 256,
        nheads: int = 8,
        enc_layers: int = 6,
        dec_layers: int = 6,
        dim_feedforward: int = 2048,
        num_feature_levels: int = 4,
        enc_n_points: int = 4,
        dec_n_points: int = 4,
        backbone_name: str = "resnet50",
        pe_temperature_h: float = 20.0,
        pe_temperature_w: float = 20.0,
        return_interm_indices: Tuple[int, ...] = (1, 2, 3),
        dn_number: int = 100,
        dn_single_pad: int = 20,
        dn_label_noise_ratio: float = 0.5,
        dn_box_noise_scale: float = 1.0,
        dn_labelbook_size: Optional[int] = None,  # None: num_classes
        use_remat: bool = False,
        dtype: torch.dtype = torch.float32,
        fast_norm: bool = False,
    ):
        super().__init__()
        C = hidden_dim
        self.dtype, self.fast_norm = dtype, fast_norm
        self.num_classes = num_classes
        self.num_queries = num_queries
        self.dn_number, self.dn_single_pad = dn_number, dn_single_pad
        self.dn_label_noise_ratio = dn_label_noise_ratio
        self.dn_box_noise_scale = dn_box_noise_scale
        self.use_remat = use_remat
        self.hidden_dim, self.num_feature_levels = C, num_feature_levels
        self.enc_layers, self.dec_layers = enc_layers, dec_layers
        self.pe_temperature_h = pe_temperature_h
        self.pe_temperature_w = pe_temperature_w
        if backbone_name not in RESNET_STAGES:
            raise ValueError(f"unsupported backbone {backbone_name!r}")
        self.backbone = ResNet(RESNET_STAGES[backbone_name],
                               return_interm_indices, dtype)
        in_chs = [RESNET_CHANNELS[s] for s in return_interm_indices]
        for i in range(num_feature_levels):
            if i < len(in_chs):
                conv = Conv2d(in_chs[i], C, 1, dtype=dtype)
            else:  # level len(feats) projects the raw last backbone stage
                cin = in_chs[-1] if i == len(in_chs) else C
                conv = Conv2d(cin, C, 3, stride=2, padding=1, dtype=dtype)
            self.add_module(f"input_proj{i}_conv", conv)
            self.add_module(f"input_proj{i}_norm",
                            group_norm(C, dtype, fast_norm))
        self.level_embed = nn.Parameter(torch.empty(num_feature_levels, C))
        for i in range(enc_layers):
            self.add_module(f"enc_layer{i}", DeformableEncoderLayer(
                C, dim_feedforward, num_feature_levels, nheads,
                enc_n_points, dtype, fast_norm))
        for i in range(dec_layers):
            self.add_module(f"dec_layer{i}", DeformableDecoderLayer(
                C, dim_feedforward, num_feature_levels, nheads,
                dec_n_points, dtype, fast_norm))
        self.decoder_norm = layer_norm(C, dtype, fast_norm)
        self.ref_point_head = MLP(2 * C, C, C, 2, dtype=dtype)
        self.class_head = Linear(C, num_classes, dtype=dtype)
        self.bbox_head = MLP(C, C, 4, 3, last_zero_init=True, dtype=dtype)
        self.enc_out_class_head = Linear(C, num_classes, dtype=dtype)
        self.enc_out_bbox_head = MLP(C, C, 4, 3, last_zero_init=True,
                                     dtype=dtype)
        self.enc_output = Linear(C, C, dtype=dtype)
        self.enc_output_norm = layer_norm(C, dtype, fast_norm)
        self.tgt_embed = nn.Parameter(torch.empty(num_queries, C))
        labelbook = num_classes if dn_labelbook_size is None \
            else dn_labelbook_size
        self.label_enc = nn.Parameter(torch.empty(labelbook + 1, C))
        # DA heads, registered last so the seeded init of everything before
        # them does not depend on them
        self.d_img = ImageDiscriminator(C, dtype=dtype)
        self.proto_d = MLP(C, C, 1, 3, dtype=dtype)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "DINO":
        """Seeded init following the flax scheme of datr_tpu: lecun-normal
        (truncated) kernels and zero biases, unit norms, identity frozen BN,
        directional sampling offsets, zero-init box-delta last layers, class
        bias prior 0.01, level_embed / tgt_embed / label_enc ~ N(0, 1)."""
        def lecun_(w, fan_in):
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)

        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                lecun_(m.weight, m.weight[0].numel())
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm, FastLayerNorm,
                                FastGroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, FrozenBatchNorm):
                m.reset()
            elif isinstance(m, MultiheadAttention):
                for w in m.in_proj_weight.chunk(3):
                    lecun_(w, w.shape[1])
                m.in_proj_bias.zero_()
        for m in self.modules():  # overrides of the generic pass above
            if isinstance(m, MSDeformAttn):
                m.reset_sampling()
            elif isinstance(m, MLP) and m.last_zero_init:
                last = getattr(m, f"layer{m.num_layers - 1}")
                last.weight.zero_()
                last.bias.zero_()
        prior_bias = -math.log((1 - 0.01) / 0.01)
        self.class_head.bias.fill_(prior_bias)
        self.enc_out_class_head.bias.fill_(prior_bias)
        self.level_embed.normal_(generator=generator)
        self.tgt_embed.normal_(generator=generator)
        self.label_enc.normal_(generator=generator)
        return self

    # ------------------------------------------------------------------
    def _extract_features(self, images, pad_mask):
        """images [B,H,W,3], pad_mask [B,H,W] -> per level: src [B,C,h,w],
        mask [B,h,w], pos [B,h,w,C]."""
        feats = self.backbone(images)
        srcs, masks, poss = [], [], []
        for lvl in range(self.num_feature_levels):
            if lvl < len(feats):
                x = feats[lvl]
            elif lvl == len(feats):
                x = feats[-1]
            else:
                x = srcs[-1]
            conv = getattr(self, f"input_proj{lvl}_conv")
            norm = getattr(self, f"input_proj{lvl}_norm")
            s = norm(conv(x))
            # "nearest-exact" is the index rule of jax.image.resize(...,
            # "nearest"); plain "nearest" differs at odd sizes
            m = F.interpolate(pad_mask[:, None].to(torch.float32),
                              size=s.shape[-2:], mode="nearest-exact")
            m = m[:, 0].to(torch.bool)
            p = position_embedding_sine_hw(
                m, self.hidden_dim // 2, self.pe_temperature_h,
                self.pe_temperature_w).to(self.dtype)
            srcs.append(s)
            masks.append(m)
            poss.append(p)
        return srcs, masks, poss

    def _flatten_levels(self, srcs, masks, poss):
        B = srcs[0].shape[0]
        spatial_shapes = tuple((int(s.shape[2]), int(s.shape[3]))
                               for s in srcs)
        src_flat = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        mask_flat = torch.cat([m.reshape(B, -1) for m in masks], 1)
        pos_flat = torch.cat(
            [p.reshape(B, -1, p.shape[-1]) + self.level_embed[i]
             for i, p in enumerate(poss)], 1)
        return src_flat, mask_flat, pos_flat, spatial_shapes

    def _two_stage_select(self, memory, mask_flat, spatial_shapes):
        """Top-k encoder proposals (datr_tpu/models/dino.py:280-330)."""
        B = memory.shape[0]
        dev = memory.device
        proposals = []
        offset = 0
        for lvl, (h, w) in enumerate(spatial_shapes):
            m = mask_flat[:, offset:offset + h * w].reshape(B, h, w)
            offset += h * w
            valid_h = (~m[:, :, 0]).sum(1).to(torch.float32)
            valid_w = (~m[:, 0, :]).sum(1).to(torch.float32)
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=dev),
                torch.arange(w, dtype=torch.float32, device=dev),
                indexing="ij")
            grid = torch.stack([gx, gy], -1).reshape(1, h * w, 2)
            scale = torch.stack([valid_w, valid_h], -1).reshape(B, 1, 2)
            centers = (grid + 0.5) / scale
            wh = torch.full_like(centers, 0.05 * (2.0 ** lvl))
            proposals.append(torch.cat([centers, wh], -1))
        proposals = torch.cat(proposals, 1)  # [B, S, 4]

        # invalid or padded positions: zeroed memory and a 1e6 proposal
        # logit, but not excluded from the top-k (reference semantics)
        prop_valid = (((proposals > 0.01) & (proposals < 0.99)).all(-1)
                      & ~mask_flat)
        out_memory = memory.masked_fill(~prop_valid[..., None], 0.0)
        out_memory = self.enc_output_norm(self.enc_output(out_memory))
        prop_unsig = torch.where(prop_valid[..., None],
                                 inverse_sigmoid(proposals),
                                 torch.full_like(proposals, 1e6))

        enc_class = self.enc_out_class_head(out_memory)  # [B, S, K]
        enc_coord_unsig = self.enc_out_bbox_head(out_memory) + prop_unsig
        topk_idx = _stable_topk_indices(enc_class.max(-1).values,
                                        self.num_queries)
        ref_unsig = _gather_rows(enc_coord_unsig, topk_idx)  # [B, nq, 4]
        tgt = _gather_rows(out_memory, topk_idx)  # [B, nq, C]
        init_box_proposal = _gather_rows(prop_unsig, topk_idx).sigmoid()
        return ref_unsig, tgt, init_box_proposal, topk_idx

    def _layer(self, layer, *args):
        """One encoder/decoder layer; recomputed in the backward when
        `use_remat` (datr_tpu's nn.remat per layer, dino.py:154-156)."""
        if self.use_remat and torch.is_grad_enabled():
            return checkpoint(layer, *args, use_reentrant=False)
        return layer(*args)

    def _transformer_pass(self, src_flat, mask_flat, pos_flat, valid_ratios,
                          spatial_shapes, dn_embed=None, dn_bbox_unsig=None,
                          self_attn_mask=None):
        """Encoder, two-stage selection and the decoder, with the DN queries
        in front of the matching queries when given
        (datr_tpu/models/dino.py:335-407)."""
        B = src_flat.shape[0]
        enc_ref = encoder_reference_points(spatial_shapes, valid_ratios)
        memory = src_flat
        for i in range(self.enc_layers):
            memory = self._layer(getattr(self, f"enc_layer{i}"), memory,
                                 pos_flat, enc_ref, spatial_shapes, mask_flat)

        ref_unsig_undetach, tgt_undetach, init_box_proposal, topk_idx = (
            self._two_stage_select(memory, mask_flat, spatial_shapes))
        ref_unsig = ref_unsig_undetach.detach()
        x = self.tgt_embed[None].expand(B, -1, -1).to(self.dtype)
        if dn_embed is not None:
            x = torch.cat([dn_embed, x], 1)
            ref_unsig = torch.cat([dn_bbox_unsig, ref_unsig], 1)
        ref = ref_unsig.sigmoid()
        hs_list, refs_list = [], [ref]
        vr4 = torch.cat([valid_ratios, valid_ratios], -1)
        for i in range(self.dec_layers):
            ref_input = ref[:, :, None, :] * vr4[:, None, :, :]  # [B,N,L,4]
            query_pos = self.ref_point_head(sine_embed_for_position(
                ref_input[:, :, 0, :], self.hidden_dim // 2).to(self.dtype))
            x = self._layer(getattr(self, f"dec_layer{i}"), x, query_pos,
                            memory, ref_input, spatial_shapes, mask_flat,
                            self_attn_mask)
            # refinement uses the un-normed output; the heads the normed one.
            # The next layer's reference is detached, the output is not.
            new_ref = (self.bbox_head(x) + inverse_sigmoid(ref)).sigmoid()
            refs_list.append(new_ref)
            ref = new_ref.detach()
            hs_list.append(self.decoder_norm(x))
        return (torch.stack(hs_list), torch.stack(refs_list), tgt_undetach,
                ref_unsig_undetach, init_box_proposal, topk_idx)

    def _head_outputs(self, hs, refs):
        """hs [n_dec,B,N,C] pairs with refs[:-1] (dino.py:452-458)."""
        logits = self.class_head(hs)
        coords = (self.bbox_head(hs) + inverse_sigmoid(refs[:-1])).sigmoid()
        return logits, coords

    def forward(self, images: torch.Tensor, pad_mask: torch.Tensor,
                targets: Optional[Dict[str, torch.Tensor]] = None,
                train: bool = False,
                global_proto: Optional[torch.Tensor] = None,
                amount: Optional[torch.Tensor] = None,
                dn_generator: Optional[torch.Generator] = None,
                dn_draws: Optional[CdnDraws] = None,
                self_training: bool = False,
                domain_adapt: bool = True) -> Dict[str, torch.Tensor]:
        """images [B, H, W, 3] f32 normalized, pad_mask [B, H, W] True = pad.

        Eval (`train=False`): the eval outputs of datr_tpu's DINO (pred_*,
        aux_*, interm_*, init_box_proposal) plus `topk_idx`, the two-stage
        selection.

        Train: a paired batch (first half source, second half target);
        `targets` holds the source half's boxes [B/2, T, 4] cxcywh, labels
        [B/2, T] and valid [B/2, T]; `global_proto` [K, C] and `amount` [K]
        are the running prototype state. The CDN noise comes from
        `dn_draws`, else from `dn_generator`. Returns datr_tpu's train
        outputs (dn_*, pred_*, aux_*, interm_*, da_*, new_global_proto,
        new_amount; with `self_training` also pred_/aux_/interm_*_target)
        plus `topk_idx` / `topk_idx_target`. With `domain_adapt=False` the
        whole batch is supervised (single-domain training): `targets`
        covers every image, and the outputs stop before the DA branch."""
        srcs, masks, poss = self._extract_features(images, pad_mask)
        src_flat, mask_flat, pos_flat, spatial_shapes = self._flatten_levels(
            srcs, masks, poss)
        valid_ratios = valid_ratios_from_mask(masks)
        if not train:
            hs, refs, tgt_undetach, ref_unsig, init_box_proposal, topk_idx = (
                self._transformer_pass(src_flat, mask_flat, pos_flat,
                                       valid_ratios, spatial_shapes))
            logits, coords = self._head_outputs(hs, refs)
            return {
                "pred_logits": logits[-1],
                "pred_boxes": coords[-1],
                "aux_logits": logits[:-1],
                "aux_boxes": coords[:-1],
                "interm_logits": self.enc_out_class_head(tgt_undetach),
                "interm_boxes": ref_unsig.sigmoid(),
                "init_box_proposal": init_box_proposal,
                "topk_idx": topk_idx,
            }
        return self._train_forward(srcs, src_flat, mask_flat, pos_flat,
                                   valid_ratios, spatial_shapes, targets,
                                   global_proto, amount, dn_generator,
                                   dn_draws, self_training, domain_adapt)

    def _train_forward(self, srcs, src_flat, mask_flat, pos_flat,
                       valid_ratios, spatial_shapes, targets, global_proto,
                       amount, dn_generator, dn_draws, self_training,
                       domain_adapt=True):
        B = src_flat.shape[0]
        if domain_adapt and B % 2:
            raise ValueError("paired DA batches must have an even batch size")
        half = B // 2 if domain_adapt else B
        dev = src_flat.device
        K, C = self.num_classes, self.hidden_dim
        if global_proto is None:
            global_proto = torch.zeros(K, C, device=dev)
        if amount is None:
            amount = torch.zeros(K, device=dev)

        out: Dict[str, torch.Tensor] = {}
        dn_embed = dn_bbox = attn_mask = cdn = None
        pad_size = 0
        if self.dn_number > 0:
            groups, pad_size = cdn_layout(self.dn_number, self.dn_single_pad)
            if dn_draws is None:
                dn_draws = draw_cdn_noise(dn_generator, half, groups,
                                          self.dn_single_pad, K, dev)
            cdn = build_cdn_queries(
                dn_draws, targets["boxes"], targets["labels"],
                targets["valid"], self.label_enc, self.dn_number,
                self.dn_single_pad, self.dn_label_noise_ratio,
                self.dn_box_noise_scale)
            attn_mask = cdn_self_attn_mask(self.num_queries,
                                           self.dn_single_pad, groups, dev)
            dn_embed = cdn.query_label_embed.to(self.dtype)
            dn_bbox = cdn.query_bbox_unsig

        # ---- source pass, DN split off (dino.py:545-568)
        hs, refs, tgt_undetach, ref_unsig, init_box_proposal, topk_idx = (
            self._transformer_pass(src_flat[:half], mask_flat[:half],
                                   pos_flat[:half], valid_ratios[:half],
                                   spatial_shapes, dn_embed, dn_bbox,
                                   attn_mask))
        logits_all, coords_all = self._head_outputs(hs, refs)
        if cdn is not None:
            out["dn_logits"] = logits_all[:, :, :pad_size]
            out["dn_boxes"] = coords_all[:, :, :pad_size]
            out["dn_valid"] = cdn.dn_valid
        logits = logits_all[:, :, pad_size:]
        coords = coords_all[:, :, pad_size:]
        out["pred_logits"] = logits[-1]
        out["pred_boxes"] = coords[-1]
        out["aux_logits"] = logits[:-1]
        out["aux_boxes"] = coords[:-1]
        out["interm_logits"] = self.enc_out_class_head(tgt_undetach)
        out["interm_boxes"] = ref_unsig.sigmoid()
        out["init_box_proposal"] = init_box_proposal
        out["topk_idx"] = topk_idx
        if not domain_adapt:
            return out

        # ---- DA branch (dino.py:579-617)
        # image-level discriminator over both domains, every level
        out["da_backbone"] = torch.cat(
            [self.d_img(grad_reverse(s)).reshape(B, -1, 1) for s in srcs], 1)
        proto_src = class_prototypes(hs[-1][:, pad_size:],
                                     out["pred_logits"], global_proto, amount)
        # target pass, no DN
        hs_t, refs_t, tgt_undetach_t, ref_unsig_t, _, topk_idx_t = (
            self._transformer_pass(src_flat[half:], mask_flat[half:],
                                   pos_flat[half:], valid_ratios[half:],
                                   spatial_shapes))
        proto_tgt = class_prototypes(hs_t[-1], self.class_head(hs_t[-1]),
                                     proto_src.new_global_proto,
                                     proto_src.new_amount)
        protos = torch.cat([proto_src.prototypes, proto_tgt.prototypes], 0)
        out["da_protos"] = self.proto_d(grad_reverse(protos))  # [2K, 1]
        out["da_class_map_source"] = proto_src.valid_class_map
        out["da_class_map_target"] = proto_tgt.valid_class_map
        out["da_query_source"] = proto_src.prototypes
        out["da_query_target"] = proto_tgt.prototypes
        out["new_global_proto"] = proto_tgt.new_global_proto
        out["new_amount"] = proto_tgt.new_amount
        out["topk_idx_target"] = topk_idx_t
        if self_training:  # dino.py:619-628
            logits_t, coords_t = self._head_outputs(hs_t, refs_t)
            out["pred_logits_target"] = logits_t[-1]
            out["pred_boxes_target"] = coords_t[-1]
            out["aux_logits_target"] = logits_t[:-1]
            out["aux_boxes_target"] = coords_t[:-1]
            out["interm_logits_target"] = self.enc_out_class_head(
                tgt_undetach_t)
            out["interm_boxes_target"] = ref_unsig_t.sigmoid()
        return out


def build_dino_from_config(cfg, device=None, seed: int = 0) -> DINO:
    """Config -> model with seeded weights, on `device` (default: the CUDA
    card), in eval mode. Mirrors datr_tpu/models/dino.py:632-674 for the
    settings the eval and training paths read, `amp_dtype` ("float32" or
    "bfloat16") and `fast_norm` included, and refuses those it does not
    implement (masks, shared two-stage heads, any other amp_dtype:
    datr_tpu's "float64" is its x64 debugging mode)."""
    get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: getattr(
        cfg, k, d)
    dev = resolve_device(device)
    amp_dtype = get("amp_dtype", "float32")
    unsupported = {
        "masks": get("masks", False),
        "two_stage_bbox_embed_share": get("two_stage_bbox_embed_share",
                                          False),
        f"amp_dtype={amp_dtype!r}": amp_dtype not in AMP_DTYPES,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"datr_torch does not implement {bad}")
    num_classes = get("num_classes", 91)
    model = DINO(
        num_classes=num_classes,
        num_queries=get("num_queries", 900),
        hidden_dim=get("hidden_dim", 256),
        nheads=get("nheads", 8),
        enc_layers=get("enc_layers", 6),
        dec_layers=get("dec_layers", 6),
        dim_feedforward=get("dim_feedforward", 2048),
        num_feature_levels=get("num_feature_levels", 4),
        enc_n_points=get("enc_n_points", 4),
        dec_n_points=get("dec_n_points", 4),
        backbone_name=get("backbone", "resnet50"),
        pe_temperature_h=get("pe_temperatureH", 20),
        pe_temperature_w=get("pe_temperatureW", 20),
        return_interm_indices=tuple(get("return_interm_indices", [1, 2, 3])),
        dn_number=get("dn_number", 100) if get("use_dn", True) else 0,
        dn_single_pad=get("dn_single_pad", 20),
        dn_label_noise_ratio=get("dn_label_noise_ratio", 0.5),
        dn_box_noise_scale=get("dn_box_noise_scale", 1.0),
        dn_labelbook_size=get("dn_labelbook_size", num_classes),
        use_remat=get("use_remat", True),
        dtype=AMP_DTYPES[amp_dtype],
        fast_norm=bool(get("fast_norm", False)),
    )
    model.init_params(torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
