"""Seeded weights for a configuration, made on the device in a few large
calls and handed, as one state dict, to the measured program and to the
reference alike.

The scheme is flax's default initialisation, which the measured package's
own seeded models follow: lecun-normal kernels truncated at two standard
deviations, zero biases, unit norms, identity frozen batch-norm, the
deformable attention's directional sampling offsets with zero kernels,
zero-initialised box-delta last layers, the class-bias prior of 0.01, unit
normal level / query / label embeddings, Swin's relative-position bias
truncated normal at 0.02. Two departures, both stated in the
configurations' `assumed`: Swin's patch embedding gets a small normal bias
(with a zero one, zero-padded tokens stay exactly 0 through every block),
and every draw comes from one device generator rather than leaf by leaf.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from ..reference import model as ref

TRUNC = 0.87962566103423978  # std of a unit normal truncated at +-2


def _directional_bias(n_heads: int, n_levels: int, n_points: int):
    th = torch.arange(n_heads, dtype=torch.float32) * (2.0 * math.pi / n_heads)
    grid = torch.stack([th.cos(), th.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True).values
    grid = grid[:, None, None, :].repeat(1, n_levels, n_points, 1)
    scale = torch.arange(1, n_points + 1, dtype=torch.float32)
    return (grid * scale[None, None, :, None]).reshape(-1)


def plan(model: nn.Module) -> Tuple[Dict[str, torch.Tensor], list, list]:
    """(constants, truncated-normal draws, normal draws) for `model`'s
    state dict: the draws as (name, std) in state-dict order."""
    sd = model.state_dict()
    const: Dict[str, torch.Tensor] = {}
    trunc: List[Tuple[str, float]] = []
    normal: List[Tuple[str, float]] = []
    prior = -math.log((1 - 0.01) / 0.01)
    for mname, m in model.named_modules():
        p = f"{mname}." if mname else ""
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            trunc.append((p + "weight", 1.0 / math.sqrt(m.weight[0].numel())
                          / TRUNC))
            if m.bias is not None:
                const[p + "bias"] = torch.zeros_like(m.bias)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            const[p + "weight"] = torch.ones_like(m.weight)
            const[p + "bias"] = torch.zeros_like(m.bias)
        elif isinstance(m, ref.FrozenBatchNorm):
            for k in ("weight", "running_var"):
                const[p + k] = torch.ones_like(getattr(m, k))
            for k in ("bias", "running_mean"):
                const[p + k] = torch.zeros_like(getattr(m, k))
        elif isinstance(m, ref.MultiheadAttention):
            d = m.in_proj_weight.shape[1]
            trunc.append((p + "in_proj_weight", 1.0 / math.sqrt(d) / TRUNC))
            const[p + "in_proj_bias"] = torch.zeros_like(m.in_proj_bias)
        elif isinstance(m, ref.WindowAttention):
            trunc.append((p + "relative_position_bias_table", 0.02 / TRUNC))
    for mname, m in model.named_modules():
        p = f"{mname}." if mname else ""
        if isinstance(m, ref.MSDeformAttn):
            so, aw = m.sampling_offsets, m.attention_weights
            const[p + "sampling_offsets.weight"] = torch.zeros_like(so.weight)
            const[p + "sampling_offsets.bias"] = _directional_bias(
                m.n_heads, m.n_levels, m.n_points)
            const[p + "attention_weights.weight"] = torch.zeros_like(aw.weight)
            const[p + "attention_weights.bias"] = torch.zeros_like(aw.bias)
        elif isinstance(m, ref.MLP) and m.last_zero_init:
            last = f"{p}layer{m.num_layers - 1}."
            const[last + "weight"] = torch.zeros_like(
                getattr(m, f"layer{m.num_layers - 1}").weight)
            const[last + "bias"] = torch.zeros_like(
                getattr(m, f"layer{m.num_layers - 1}").bias)
        elif isinstance(m, ref.SwinTransformer):
            normal.append((p + "patch_embed.bias", 0.02))
            const.pop(p + "patch_embed.bias", None)
    for k in ("class_head.bias", "enc_out_class_head.bias"):
        const[k] = torch.full_like(sd[k], prior)
    for k in ("level_embed", "tgt_embed", "label_enc"):
        normal.append((k, 1.0))
    drawn = {k for k, _ in trunc} | {k for k, _ in normal}
    trunc = [(k, s) for k, s in trunc if k not in const]
    normal = [(k, s) for k, s in normal if k not in const]
    missing = set(sd) - set(const) - drawn
    if missing:
        raise KeyError(f"no initialisation for {sorted(missing)}")
    return const, trunc, normal


def make_state_dict(model: nn.Module, seed: int,
                    device) -> Dict[str, torch.Tensor]:
    """`model`'s state dict drawn from `seed` on `device`: one truncated
    normal and one normal draw for all leaves, split and scaled."""
    const, trunc, normal = plan(model)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    out = {k: v.to(device) for k, v in const.items()}
    for draws, kind in ((trunc, "trunc"), (normal, "normal")):
        sizes = [shapes[k].numel() for k, _ in draws]
        flat = torch.empty(sum(sizes), device=device)
        if kind == "trunc":
            nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
        else:
            flat.normal_(generator=gen)
        for (k, std), part in zip(draws, flat.split(sizes)):
            out[k] = part.mul_(std).view(shapes[k])
    return {k: out[k] for k in shapes}
