"""Two configurations the port reads that no other port test names, through
both packages' own config loaders and model builders, at a tiny width in
f32 on the CPU: configs/DINO/DINO_5scale.py (5 levels from backbone
stages [0, 1, 2, 3]: a stride-4 level and a stride-64 level) and
configs/DINO/DINO_4scale_fast.py (2 sampling points per level in the
encoder and the decoder). The whole eval forward on a padded batch against
datr_tpu's, with seeded parameters of datr_tpu's tree; the two-stage
selection equal; logits within atol 2e-3 and boxes within 1e-4, the
tolerances of tests/test_torch_port_serve.py."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch.config import apply_overrides, load_config
from datr_torch.convert import load_flax_params
from datr_torch.models.dino import build_dino_from_config
from datr_torch.models.layers import MSDeformAttn
from datr_tpu import config as jconfig
from datr_tpu.models.dino import build_dino_from_config as jax_build

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_bf16 import seeded_params  # noqa: E402

CANVAS = (64, 96)
TINY = ["num_classes=4", "hidden_dim=32", "nheads=2", "enc_layers=1",
        "dec_layers=2", "dim_feedforward=64", "num_queries=12",
        "dn_number=2", "dn_single_pad=2", "dn_labelbook_size=4",
        "use_remat=False"]
LOGIT_ATOL, BOX_ATOL = 2e-3, 1e-4


@pytest.mark.parametrize("path,levels,points", [
    ("configs/DINO/DINO_5scale.py", 5, 4),
    ("configs/DINO/DINO_4scale_fast.py", 4, 2),
])
def test_config_eval_forward_matches_datr_tpu(path, levels, points,
                                              monkeypatch):
    cfg = apply_overrides(load_config(path), TINY)
    jcfg = jconfig.apply_overrides(jconfig.load_config(path), TINY)
    assert dict(cfg) == dict(jcfg)
    tm = build_dino_from_config(cfg, device="cpu").eval()
    jm = jax_build(jcfg)
    msda = [m for m in tm.modules() if isinstance(m, MSDeformAttn)]
    assert tm.num_feature_levels == levels and msda
    assert all((m.n_levels, m.n_points) == (levels, points) for m in msda)

    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, *CANVAS, 3)).astype(np.float32)
    pm = np.zeros((2, *CANVAS), bool)
    pm[0, 52:] = True
    pm[1, :, 75:] = True
    img[pm] = 0.0
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, *CANVAS, 3)), jnp.zeros((1, *CANVAS), bool),
        train=False), jax.random.PRNGKey(0))
    params = {"params": seeded_params(shapes["params"])}
    load_flax_params(tm, params)

    seen = {}
    top_k = jax.lax.top_k

    def spy(x, k):  # the first top_k of the forward is the two-stage one
        v, i = top_k(x, k)
        seen.setdefault("idx", i)
        return v, i

    monkeypatch.setattr(jax.lax, "top_k", spy)
    want, want_idx = jax.device_get(jax.jit(
        lambda p, a, b: (jm.apply(p, a, b, train=False), seen["idx"]))(
            params, img, pm))
    with torch.no_grad():
        got = tm(torch.from_numpy(img), torch.from_numpy(pm))
    np.testing.assert_array_equal(got["topk_idx"].numpy(), want_idx)
    for key, w in want.items():
        atol = LOGIT_ATOL if "logits" in key else BOX_ATOL
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=atol,
                                   err_msg=key)
