"""DINO detection transformer with domain adaptation (port of
datr_tpu/models/dino.py).

Eval (dino.py:478-509): backbone (ResNet, Swin or ConvNeXt:
`make_backbone`) -> input projections -> deformable encoder
layers -> two-stage top-k -> deformable decoder layers with iterative box
refinement -> shared heads.

Train (dino.py:511-629) takes a paired batch, first half source and second
half target: the source pass with CDN denoising queries split off the
outputs, the image discriminator behind gradient reversal over every level,
class prototypes of both domains, and the target pass without DN. With
`use_remat` each encoder and decoder layer is recomputed in the backward
(torch.utils.checkpoint). With `self_training` the target pass's own
detection outputs come back too (`*_target`). With `with_masks` the
instance-mask head (models/segmentation.py, datr_tpu's DETRsegm wiring,
dino.py:102-129, 431-450) adds `pred_masks` [B, Q, h4, w4] to the eval
outputs and to the supervised half's train outputs (the matching queries,
after the DN split); the backbone then also returns its stride-4 / 8 / 16
stages, which the head's adapters read.
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

Model axes (datr_tpu/models/dino.py:351-367, 409-429): `encoder_fn`
replaces the in-module encoder stack (the pipelined encoder of
parallel/pipeline.py `make_pp_encoder_fn`). With `sp_axis` naming a mesh
axis of more than one rank (parallel/mesh.py, 'seq'), each rank runs every
encoder layer for its share of the S query tokens (its queries, positions
and reference points; the shares may be uneven), each layer's value table
the whole sequence gathered over the axis, with the whole padding mask;
the memory is gathered once after the encoder and every rank runs the
two-stage selection and the decoder on all of it. The encoder layers'
parameter gradients, each rank's part, are summed over the axis.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..parallel import dist as pdist
from ..utils.misc import inverse_sigmoid, sine_embed_for_position
from .cdn import (
    CdnDraws,
    build_cdn_queries,
    cdn_layout,
    cdn_self_attn_mask,
    draw_cdn_noise,
)
from .convnext import (
    CONVNEXT_CONFIGS,
    LAYER_SCALE_INIT,
    ConvNeXt,
    ConvNeXtBlock,
)
from .da import ImageDiscriminator, class_prototypes, grad_reverse
from .segmentation import MaskHeadSmallConv, MHAttentionMap, mask_head_forward
from .layers import MLP, Conv2d, Linear, MSDeformAttn
from .norms import FastGroupNorm, FastLayerNorm, group_norm, layer_norm
from .position_encoding import position_embedding_sine_hw
from .resnet import FrozenBatchNorm, ResNet
from .swin import SWIN_CONFIGS, SwinTransformer, WindowAttention
from .transformer import (
    DeformableDecoderLayer,
    DeformableEncoderLayer,
    MultiheadAttention,
    encoder_reference_points,
    valid_ratios_from_mask,
)

RESNET_STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
AMP_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_backbone(name: str, dtype: torch.dtype = torch.float32,
                  return_stages=(1, 2, 3)) -> nn.Module:
    """The backbone `name` (datr_tpu/models/dino.py:47-69): resnet50/101,
    a `swin.SWIN_CONFIGS` or a `convnext.CONVNEXT_CONFIGS` entry.
    `return_stages`: 0 = the stride-4 stage ... 3 = stride 32. The module
    takes images [B, H, W, 3], returns the NCHW features of those stages,
    and names each stage's width in `widths`."""
    return_stages = tuple(return_stages)
    if name in RESNET_STAGES:
        return ResNet(RESNET_STAGES[name], return_stages, dtype)
    if name in SWIN_CONFIGS:
        return SwinTransformer(**SWIN_CONFIGS[name],
                               return_stages=return_stages, dtype=dtype)
    if name in CONVNEXT_CONFIGS:
        return ConvNeXt(**CONVNEXT_CONFIGS[name],
                        return_stages=return_stages, dtype=dtype)
    known = [*RESNET_STAGES, *SWIN_CONFIGS, *CONVNEXT_CONFIGS]
    raise ValueError(f"unknown backbone {name!r}; supported: {known}")


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
        with_masks: bool = False,
        mask_query_chunk: int = 0,
        two_stage_share_heads: bool = False,
        sp_axis: str = "",
    ):
        super().__init__()
        C = hidden_dim
        self.sp_axis = sp_axis
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
        self.return_interm_indices = tuple(return_interm_indices)
        self.with_masks, self.mask_query_chunk = with_masks, mask_query_chunk
        self.two_stage_share_heads = two_stage_share_heads
        # the mask head's laterals are the raw stages 0..2 (C2 / C3 / C4):
        # the backbone returns their union with the detection stages
        stages = self.return_interm_indices
        if with_masks:
            stages = tuple(sorted(set(stages) | {0, 1, 2}))
        self.backbone_stages = stages
        self.backbone = make_backbone(backbone_name, dtype, stages)
        in_chs = [self.backbone.widths[s] for s in return_interm_indices]
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
        if not two_stage_share_heads:  # shared: the properties below
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
        if with_masks:  # after the rest, for the same reason
            self.bbox_attention = MHAttentionMap(C, nheads, dtype=dtype)
            self.mask_head = MaskHeadSmallConv(
                C + nheads, C, [self.backbone.widths[s] for s in (2, 1, 0)],
                dtype=dtype)

    # The encoder's proposal heads. With `two_stage_share_heads` they are the
    # decoder's `class_head` / `bbox_head` themselves (datr_tpu/models/
    # dino.py:194-196): one module and one state-dict entry per tensor, as
    # datr_tpu's tree has no enc_out_* entries, and each shared tensor's
    # gradient sums both uses. Assigning the decoder's heads to these names
    # would register them twice (two state-dict keys).
    @property
    def enc_out_class_head(self) -> nn.Module:
        if self.two_stage_share_heads:
            return self.class_head
        return self._modules["enc_out_class_head"]

    @property
    def enc_out_bbox_head(self) -> nn.Module:
        if self.two_stage_share_heads:
            return self.bbox_head
        return self._modules["enc_out_bbox_head"]

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
            elif isinstance(m, WindowAttention):
                # flax truncated_normal(0.02): within 2 std, std corrected
                std = 0.02 / 0.87962566103423978
                nn.init.trunc_normal_(m.relative_position_bias_table,
                                      std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
            elif isinstance(m, ConvNeXtBlock):
                m.gamma.fill_(LAYER_SCALE_INIT)
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
        mask [B,h,w], pos [B,h,w,C]; and the raw backbone stages by
        index."""
        stage_feats = dict(zip(self.backbone_stages, self.backbone(images)))
        feats = [stage_feats[s] for s in self.return_interm_indices]
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
        return srcs, masks, poss, stage_feats

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

    def _sp_layer(self, layer, *args):
        """`layer` with its parameters entering the 'seq' region: each
        rank's part of their gradient is summed over the axis."""
        params = {n: pdist.copy_to(p, self.sp_axis)
                  for n, p in layer.named_parameters()}
        return functional_call(layer, params, args)

    def _sp_encoder(self, src, pos, ref, spatial_shapes, mask):
        """The encoder stack under sequence parallelism: this rank's rows
        of the queries through every layer, each layer's value the whole
        sequence (gathered; its gradient summed over the axis), the memory
        gathered once at the end (datr_tpu's `_sp_constraint`,
        dino.py:359-367)."""
        ax, S = self.sp_axis, src.shape[1]
        x = pdist.split(src, 1, ax)
        pos, ref = pdist.split(pos, 1, ax), pdist.split(ref, 1, ax)
        value = pdist.copy_to(src, ax)  # whole already: layer 0's value
        for i in range(self.enc_layers):
            if i:
                value = pdist.gather_sum(x, 1, S, ax)
            x = self._layer(functools.partial(
                self._sp_layer, getattr(self, f"enc_layer{i}")),
                x, pos, ref, spatial_shapes, mask, value)
        return pdist.gather_replicated(x, 1, S, ax)

    def _transformer_pass(self, src_flat, mask_flat, pos_flat, valid_ratios,
                          spatial_shapes, dn_embed=None, dn_bbox_unsig=None,
                          self_attn_mask=None, encoder_fn=None):
        """Encoder, two-stage selection and the decoder, with the DN queries
        in front of the matching queries when given
        (datr_tpu/models/dino.py:335-407). `encoder_fn(src, pos, ref, mask,
        spatial_shapes)` replaces the encoder stack. Returns the decoder's
        hidden states and references, the two-stage outputs, the top-k
        indices and the encoder memory."""
        B = src_flat.shape[0]
        enc_ref = encoder_reference_points(spatial_shapes, valid_ratios)
        if encoder_fn is not None:
            memory = encoder_fn(src_flat, pos_flat, enc_ref, mask_flat,
                                spatial_shapes)
        elif self.sp_axis and pdist.process_count(self.sp_axis) > 1:
            memory = self._sp_encoder(src_flat, pos_flat, enc_ref,
                                      spatial_shapes, mask_flat)
        else:
            memory = src_flat
            for i in range(self.enc_layers):
                memory = self._layer(getattr(self, f"enc_layer{i}"), memory,
                                     pos_flat, enc_ref, spatial_shapes,
                                     mask_flat)

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
                ref_unsig_undetach, init_box_proposal, topk_idx, memory)

    def _compute_masks(self, hs_last, srcs, masks, memory, spatial_shapes,
                       stage_feats):
        """The mask head (datr_tpu/models/dino.py:431-450): attention maps
        of the final hidden states against the stride-32 slice of the
        memory, the projected stride-32 source as context, the C4 / C3 / C2
        stages as laterals; f32 logits [B, Q, h4, w4]."""
        lvl = len(self.return_interm_indices) - 1  # the stride-32 level
        h, w = spatial_shapes[lvl]
        off = sum(a * b for a, b in spatial_shapes[:lvl])
        B = hs_last.shape[0]
        memory_32 = memory[:, off:off + h * w].reshape(B, h, w, -1)
        fpns = [stage_feats[2][:B], stage_feats[1][:B], stage_feats[0][:B]]
        return mask_head_forward(
            self.bbox_attention, self.mask_head, hs_last, srcs[lvl][:B],
            memory_32, masks[lvl][:B], fpns, self.mask_query_chunk,
            remat=self.use_remat).float()

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
                domain_adapt: bool = True,
                encoder_fn=None) -> Dict[str, torch.Tensor]:
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
        covers every image, and the outputs stop before the DA branch.
        `encoder_fn` replaces the encoder stack in every pass (the
        pipelined encoder, parallel/pipeline.py)."""
        srcs, masks, poss, stage_feats = self._extract_features(images,
                                                                pad_mask)
        src_flat, mask_flat, pos_flat, spatial_shapes = self._flatten_levels(
            srcs, masks, poss)
        valid_ratios = valid_ratios_from_mask(masks)
        if not train:
            (hs, refs, tgt_undetach, ref_unsig, init_box_proposal, topk_idx,
             memory) = self._transformer_pass(src_flat, mask_flat, pos_flat,
                                              valid_ratios, spatial_shapes,
                                              encoder_fn=encoder_fn)
            logits, coords = self._head_outputs(hs, refs)
            out = {
                "pred_logits": logits[-1],
                "pred_boxes": coords[-1],
                "aux_logits": logits[:-1],
                "aux_boxes": coords[:-1],
                "interm_logits": self.enc_out_class_head(tgt_undetach),
                "interm_boxes": ref_unsig.sigmoid(),
                "init_box_proposal": init_box_proposal,
                "topk_idx": topk_idx,
            }
            if self.with_masks:
                out["pred_masks"] = self._compute_masks(
                    hs[-1], srcs, masks, memory, spatial_shapes, stage_feats)
            return out
        return self._train_forward(srcs, masks, stage_feats, src_flat,
                                   mask_flat, pos_flat, valid_ratios,
                                   spatial_shapes, targets, global_proto,
                                   amount, dn_generator, dn_draws,
                                   self_training, domain_adapt, encoder_fn)

    def _train_forward(self, srcs, masks, stage_feats, src_flat, mask_flat,
                       pos_flat, valid_ratios, spatial_shapes, targets,
                       global_proto, amount, dn_generator, dn_draws,
                       self_training, domain_adapt=True, encoder_fn=None):
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
        (hs, refs, tgt_undetach, ref_unsig, init_box_proposal, topk_idx,
         memory) = (
            self._transformer_pass(src_flat[:half], mask_flat[:half],
                                   pos_flat[:half], valid_ratios[:half],
                                   spatial_shapes, dn_embed, dn_bbox,
                                   attn_mask, encoder_fn))
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
        if self.with_masks:  # the matching queries of the supervised half
            out["pred_masks"] = self._compute_masks(
                hs[-1][:, pad_size:], srcs, masks, memory, spatial_shapes,
                stage_feats)
        if not domain_adapt:
            return out

        # ---- DA branch (dino.py:579-617)
        # image-level discriminator over both domains, every level
        out["da_backbone"] = torch.cat(
            [self.d_img(grad_reverse(s)).reshape(B, -1, 1) for s in srcs], 1)
        proto_src = class_prototypes(hs[-1][:, pad_size:],
                                     out["pred_logits"], global_proto, amount)
        # target pass, no DN
        hs_t, refs_t, tgt_undetach_t, ref_unsig_t, _, topk_idx_t, _ = (
            self._transformer_pass(src_flat[half:], mask_flat[half:],
                                   pos_flat[half:], valid_ratios[half:],
                                   spatial_shapes, encoder_fn=encoder_fn))
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
    "bfloat16"), `fast_norm` and `two_stage_bbox_embed_share` (the encoder's
    proposal heads are the decoder's) included, and refuses any other
    amp_dtype (datr_tpu's "float64" is its x64 debugging mode: ROADMAP
    §A, `amp_dtype="float64"`). `masks` builds the mask head,
    `mask_query_chunk` bounds its live (image, query) pairs. `sp_axis`
    names the mesh axis of encoder sequence parallelism (datr_tpu's key,
    dino.py:669; "" or an axis of one rank: none)."""
    get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: getattr(
        cfg, k, d)
    dev = resolve_device(device)
    amp_dtype = get("amp_dtype", "float32")
    if amp_dtype not in AMP_DTYPES:
        raise NotImplementedError(
            f"datr_torch does not implement amp_dtype={amp_dtype!r} "
            f"(it runs {sorted(AMP_DTYPES)}; float64: ROADMAP §A, "
            "amp_dtype=\"float64\")")
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
        with_masks=bool(get("masks", False)),
        mask_query_chunk=int(get("mask_query_chunk", 0) or 0),
        two_stage_share_heads=bool(get("two_stage_bbox_embed_share", False)),
        sp_axis=get("sp_axis", "") or "",
    )
    model.init_params(torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


from .registry import register_model  # noqa: E402


@register_model("dino")
def _build_dino_entry(cfg, device=None, seed: int = 0):
    """datr_tpu/models/dino.py:677-719: the model and its criterion."""
    from ..train.criterion import criterion_from_config

    model = build_dino_from_config(cfg, device, seed=seed)
    ccfg, weight_dict = criterion_from_config(cfg, model)
    return model, ccfg, weight_dict
