"""The port's tensor-parallel plan (datr_torch/parallel/mesh.py `tp_plan`,
`_TP_RULES`) against datr_tpu's `param_sharding_tree` (datr_tpu/parallel/
mesh.py:42-123) on the CPU: for the flagship, Swin-L and ConvNeXt-XL
configurations the port splits the same tensors, each on the port's dim of
datr_tpu's axis, at tp = 2; the divisibility guard agrees at a tp that
divides nothing and at one that divides all but the MHA's heads; and
`apply_tp` refuses a layer it cannot run. The trees are shapes only:
`jax.eval_shape` on datr_tpu's side, the meta device on the port's."""

import os
import sys

import jax
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch.config import load_config as t_load
from datr_torch.convert import state_dict_from_flax
from datr_torch.models import dino as tdino
from datr_torch.parallel.mesh import LocalTP, TPSplit, apply_tp, tp_plan
from datr_tpu.config import load_config as j_load
from datr_tpu.models import dino as jdino
from datr_tpu.parallel.mesh import make_mesh as jax_mesh
from datr_tpu.parallel.mesh import param_sharding_tree

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_backbones import train_tree_shapes  # noqa: E402
from test_torch_port_selftrain import KW as TINY  # noqa: E402

TP = 2
CONFIGS = {"flagship": "configs/DINO/DINO_4scale.py",
           "swin_L": "configs/DINO/DINO_4scale_swin.py",
           "convnext_XL": "configs/DINO/DINO_4scale_convnext.py"}


def _flax_to_port(path, ndim, axis):
    """The port's name and TPSplit of a flax leaf split on `axis`
    (state_dict_from_flax's map: dense [in, out] -> [out, in], the MHA's
    query / key / value -> rows of in_proj_*, out -> out_proj)."""
    *mod, leaf = path
    if mod and mod[-1] in ("query", "key", "value"):
        return ".".join(mod[:-1] + [f"in_proj_{'weight' if leaf == 'kernel' else 'bias'}"]), TPSplit(0, 3)
    if mod and mod[-1] == "out":
        return ".".join(mod[:-1] + ["out_proj", "weight"]), TPSplit(1)
    name = ".".join(mod + ["weight" if leaf == "kernel" else leaf])
    return name, TPSplit(ndim - 1 - axis if leaf == "kernel" else axis)


def _jax_plan(shapes, tp, n_devices):
    """datr_tpu's param_sharding_tree over `shapes` (a flax tree of
    ShapeDtypeStructs) as {port name: TPSplit}."""
    specs = param_sharding_tree(shapes, jax_mesh(n_devices, tp=tp))
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    leaves = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    plan = {}
    for kp, sharding in flat:
        spec = tuple(sharding.spec)
        if "model" not in spec:
            continue
        path = [str(getattr(k, "key", k)) for k in kp]
        name, split = _flax_to_port(path, len(leaves[kp].shape),
                                    spec.index("model"))
        assert name not in plan or plan[name] == split, name
        plan[name] = split
    return plan


def _models(path):
    """datr_tpu's model of the config at `path` and the port's, built on
    the meta device (shapes only, no init)."""
    jm = jdino.build_dino_from_config(j_load(path))
    c = t_load(path)
    with torch.device("meta"):
        tm = tdino.DINO(
            num_classes=c.num_classes, num_queries=c.num_queries,
            hidden_dim=c.hidden_dim, nheads=c.nheads,
            enc_layers=c.enc_layers, dec_layers=c.dec_layers,
            dim_feedforward=c.dim_feedforward,
            num_feature_levels=c.num_feature_levels,
            enc_n_points=c.enc_n_points, dec_n_points=c.dec_n_points,
            backbone_name=c.backbone,
            return_interm_indices=tuple(c.return_interm_indices),
            dn_labelbook_size=c.get("dn_labelbook_size", c.num_classes))
    return jm, tm


@pytest.mark.parametrize("config", list(CONFIGS))
def test_tp_plan_equals_param_sharding_tree(config):
    """The port's plan at tp = 2 is datr_tpu's param_sharding_tree on
    make_mesh(8, tp=2), leaf by leaf: the same tensors split, each on the
    port's dim of datr_tpu's axis (the MHA's rows per q / k / v chunk),
    every name one that state_dict_from_flax gives."""
    jm, tm = _models(CONFIGS[config])
    shapes = train_tree_shapes(jm, (256, 384))  # S above 900 queries
    want = _jax_plan(shapes, TP, 8)
    got = tp_plan(tm, TP)
    names = set(state_dict_from_flax(jax.tree.map(
        lambda s: np.zeros((1,) * len(s.shape), np.float32), shapes)))
    assert set(want) <= names
    assert got == want
    # every FFN and MSDA of the transformer, and the decoder's MHAs
    n_msda = tm.enc_layers + tm.dec_layers
    assert len(got) == 3 * n_msda + 7 * n_msda + 3 * tm.dec_layers


@pytest.mark.parametrize("tp", [3, 8])
def test_tp_plan_guard_equals_datr_tpu(tp):
    """A dim that tp does not divide stays whole, as in datr_tpu: at 3 the
    tiny model splits nothing; at 8 its FFNs and MSDAs split but not its
    decoder MHAs (4 heads). apply_tp refuses the MSDA of 4 heads over 8
    ranks that the plan splits."""
    jm = jdino.DINO(**TINY, dn_labelbook_size=TINY["num_classes"])
    with torch.device("meta"):
        tm = tdino.DINO(**TINY, dn_labelbook_size=TINY["num_classes"])
    want = _jax_plan(train_tree_shapes(jm, (64, 96)), tp, 8 if tp == 8
                     else 6)
    got = tp_plan(tm, tp)
    assert got == want
    if tp == 3:
        assert got == {}
    else:
        assert got and not any("in_proj" in n or "out_proj" in n
                               for n in got)
        with pytest.raises(ValueError, match="4 heads"):
            apply_tp(tm, LocalTP(0, tp))
