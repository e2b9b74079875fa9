"""DINO detection transformer, eval forward (port of datr_tpu/models/dino.py).

Covers the eval branch of `DINO.__call__` (dino.py:478-509): backbone ->
input projections -> 6 deformable encoder layers -> two-stage top-k ->
6 deformable decoder layers with iterative box refinement -> shared heads.
f32 only; no CDN, no DA heads, no masks. Module attribute names mirror the
flax parameter tree (`input_proj0_conv`, `enc_layer3`, `class_head`, ...).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..utils.misc import inverse_sigmoid, sine_embed_for_position
from .layers import MLP, MSDeformAttn
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
    ):
        super().__init__()
        C = hidden_dim
        self.num_queries = num_queries
        self.hidden_dim, self.num_feature_levels = C, num_feature_levels
        self.enc_layers, self.dec_layers = enc_layers, dec_layers
        self.pe_temperature_h = pe_temperature_h
        self.pe_temperature_w = pe_temperature_w
        if backbone_name not in RESNET_STAGES:
            raise ValueError(f"unsupported backbone {backbone_name!r}")
        self.backbone = ResNet(RESNET_STAGES[backbone_name],
                               return_interm_indices)
        in_chs = [RESNET_CHANNELS[s] for s in return_interm_indices]
        for i in range(num_feature_levels):
            if i < len(in_chs):
                conv = nn.Conv2d(in_chs[i], C, 1)
            else:  # level len(feats) projects the raw last backbone stage
                cin = in_chs[-1] if i == len(in_chs) else C
                conv = nn.Conv2d(cin, C, 3, stride=2, padding=1)
            self.add_module(f"input_proj{i}_conv", conv)
            self.add_module(f"input_proj{i}_norm",
                            nn.GroupNorm(32, C, eps=1e-5))
        self.level_embed = nn.Parameter(torch.empty(num_feature_levels, C))
        for i in range(enc_layers):
            self.add_module(f"enc_layer{i}", DeformableEncoderLayer(
                C, dim_feedforward, num_feature_levels, nheads,
                enc_n_points))
        for i in range(dec_layers):
            self.add_module(f"dec_layer{i}", DeformableDecoderLayer(
                C, dim_feedforward, num_feature_levels, nheads,
                dec_n_points))
        self.decoder_norm = nn.LayerNorm(C, eps=1e-5)
        self.ref_point_head = MLP(2 * C, C, C, 2)
        self.class_head = nn.Linear(C, num_classes)
        self.bbox_head = MLP(C, C, 4, 3, last_zero_init=True)
        self.enc_out_class_head = nn.Linear(C, num_classes)
        self.enc_out_bbox_head = MLP(C, C, 4, 3, last_zero_init=True)
        self.enc_output = nn.Linear(C, C)
        self.enc_output_norm = nn.LayerNorm(C, eps=1e-5)
        self.tgt_embed = nn.Parameter(torch.empty(num_queries, C))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "DINO":
        """Seeded init following the flax scheme of datr_tpu: lecun-normal
        (truncated) kernels and zero biases, unit norms, identity frozen BN,
        directional sampling offsets, zero-init box-delta last layers, class
        bias prior 0.01, level_embed / tgt_embed ~ N(0, 1)."""
        def lecun_(w, fan_in):
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)

        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                lecun_(m.weight, m.weight[0].numel())
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
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
                self.pe_temperature_w)
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

    def _transformer_pass(self, src_flat, mask_flat, pos_flat, valid_ratios,
                          spatial_shapes):
        """Encoder, two-stage selection and the decoder without DN
        (datr_tpu/models/dino.py:335-407)."""
        B = src_flat.shape[0]
        enc_ref = encoder_reference_points(spatial_shapes, valid_ratios)
        memory = src_flat
        for i in range(self.enc_layers):
            memory = getattr(self, f"enc_layer{i}")(
                memory, pos_flat, enc_ref, spatial_shapes, mask_flat)

        ref_unsig, tgt_undetach, init_box_proposal, topk_idx = (
            self._two_stage_select(memory, mask_flat, spatial_shapes))
        ref = ref_unsig.sigmoid()
        x = self.tgt_embed[None].expand(B, -1, -1)
        hs_list, refs_list = [], [ref]
        vr4 = torch.cat([valid_ratios, valid_ratios], -1)
        for i in range(self.dec_layers):
            ref_input = ref[:, :, None, :] * vr4[:, None, :, :]  # [B,N,L,4]
            query_pos = self.ref_point_head(sine_embed_for_position(
                ref_input[:, :, 0, :], self.hidden_dim // 2))
            x = getattr(self, f"dec_layer{i}")(
                x, query_pos, memory, ref_input, spatial_shapes, mask_flat)
            # refinement uses the un-normed output; the heads the normed one
            ref = (self.bbox_head(x) + inverse_sigmoid(ref)).sigmoid()
            refs_list.append(ref)
            hs_list.append(self.decoder_norm(x))
        return (torch.stack(hs_list), torch.stack(refs_list), tgt_undetach,
                ref_unsig, init_box_proposal, topk_idx)

    def _head_outputs(self, hs, refs):
        """hs [n_dec,B,N,C] pairs with refs[:-1] (dino.py:452-458)."""
        logits = self.class_head(hs)
        coords = (self.bbox_head(hs) + inverse_sigmoid(refs[:-1])).sigmoid()
        return logits, coords

    def forward(self, images: torch.Tensor,
                pad_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images [B, H, W, 3] f32 normalized, pad_mask [B, H, W] True = pad.

        Returns the eval outputs of datr_tpu's DINO (pred_*, aux_*, interm_*,
        init_box_proposal) plus `topk_idx`, the two-stage selection."""
        srcs, masks, poss = self._extract_features(images, pad_mask)
        src_flat, mask_flat, pos_flat, spatial_shapes = self._flatten_levels(
            srcs, masks, poss)
        valid_ratios = valid_ratios_from_mask(masks)
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


def build_dino_from_config(cfg, device=None, seed: int = 0) -> DINO:
    """Config -> eval model with seeded weights, on `device` (default: the
    CUDA card). Mirrors datr_tpu/models/dino.py:632-674 for the settings
    the eval f32 path reads, and refuses those it does not implement."""
    get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: getattr(
        cfg, k, d)
    dev = resolve_device(device)
    unsupported = {
        "masks": get("masks", False),
        "two_stage_bbox_embed_share": get("two_stage_bbox_embed_share",
                                          False),
        "amp_dtype": get("amp_dtype", "float32") != "float32",
        "fast_norm": get("fast_norm", False),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"datr_torch does not implement {bad}")
    model = DINO(
        num_classes=get("num_classes", 91),
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
    )
    model.init_params(torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
