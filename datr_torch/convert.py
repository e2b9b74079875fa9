"""Carry datr_tpu's flax parameters over to the port.

The port's module attribute names mirror the flax tree, so the map is a
mechanical walk: `a/b/kernel` -> `a.b.weight` (conv HWIO -> OIHW, dense
[in, out] -> [out, in]), `scale` -> `weight` (LayerNorm/GroupNorm), frozen-BN
and bare parameters keep their names. A flax MultiHeadDotProductAttention
(`query`/`key`/`value` [d, h, hd] and `out` [h, hd, d]) becomes
`in_proj_weight` [3d, d] / `in_proj_bias` and `out_proj` (the inverse of
tools/convert_checkpoint.py:convert_mha). A reference `.pth` reaches the port
through tools/convert_checkpoint.py and then this function.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, List, Tuple

import numpy as np
import torch

# train-only parameters: CDN label embedding and the DA discriminators
TRAIN_ONLY = ("d_img", "proto_d", "label_enc")
_MHA = {"query", "key", "value", "out"}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _mha(node, prefix: str, out: Dict[str, torch.Tensor]):
    d = np.asarray(node["query"]["kernel"]).shape[0]
    ws = [np.asarray(node[n]["kernel"]).reshape(d, -1).T
          for n in ("query", "key", "value")]
    bs = [np.asarray(node[n]["bias"]).reshape(-1)
          for n in ("query", "key", "value")]
    out[prefix + "in_proj_weight"] = _t(np.concatenate(ws, 0))
    out[prefix + "in_proj_bias"] = _t(np.concatenate(bs, 0))
    out[prefix + "out_proj.weight"] = _t(
        np.asarray(node["out"]["kernel"]).reshape(-1, d).T)
    out[prefix + "out_proj.bias"] = _t(node["out"]["bias"])


def _walk(node, prefix: str, out: Dict[str, torch.Tensor]):
    if set(node) == _MHA:
        _mha(node, prefix, out)
        return
    for name, child in node.items():
        if isinstance(child, Mapping):
            _walk(child, f"{prefix}{name}.", out)
            continue
        arr = np.asarray(child)
        if name == "kernel" and arr.ndim == 4:  # conv HWIO -> OIHW
            out[prefix + "weight"] = _t(arr.transpose(3, 2, 0, 1))
        elif name == "kernel":  # dense [in, out] -> [out, in]
            out[prefix + "weight"] = _t(arr.T)
        elif name == "scale":
            out[prefix + "weight"] = _t(arr)
        else:  # bias, frozen-BN stats, level_embed, tgt_embed
            out[prefix + name] = _t(arr)


def state_dict_from_flax(params) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """datr_tpu DINO params (`{'params': tree}` or the tree, numpy or jax
    arrays) -> (the port's state_dict, names of the skipped train-only
    top-level parameters)."""
    tree = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    skipped = []
    for name, child in tree.items():
        if name in TRAIN_ONLY:
            skipped.append(name)
        elif isinstance(child, Mapping):
            _walk(child, name + ".", sd)
        else:
            sd[name] = _t(child)
    return sd, skipped
