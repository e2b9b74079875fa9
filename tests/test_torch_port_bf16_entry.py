"""bfloat16 through the port's entry points on the CPU:
build_dino_from_config with amp_dtype=bfloat16 (fast_norm off and on),
InferenceServer serving a bf16 model, and `python -m datr_torch.main --amp`
at tests/test_main_cli.py's tiny config (a burn-in epoch; a self-training
epoch with the fast norms), with the parameters, the optimizer's moments and
the EMA tracks f32 in the checkpoint. The port alone: its bf16 against
datr_tpu's is tests/test_torch_port_bf16.py and
tests/test_torch_port_bf16_train.py."""

import json
import os
import sys

import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch.models import dino as tdino
from datr_torch.models import norms as tnorms
from datr_torch.models.layers import Conv2d, Linear
from datr_torch.serve import InferenceServer

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_cli import LOG_KEYS, _cfg, _log, _run  # noqa: E402

K = 4
BF16 = torch.bfloat16

TINY = dict(num_classes=K, hidden_dim=32, nheads=2, enc_layers=1,
            dec_layers=1, dim_feedforward=64, num_queries=12, dn_number=4,
            dn_single_pad=2, use_remat=False)


@pytest.mark.parametrize("fast_norm", [False, True])
def test_build_bf16_model(fast_norm):
    """amp_dtype=bfloat16 builds: f32 parameters, every Linear / Conv2d /
    norm computing in bf16, the fast norms iff fast_norm; its eval forward
    returns bf16 logits and f32 boxes, as datr_tpu's."""
    model = tdino.build_dino_from_config(
        dict(TINY, amp_dtype="bfloat16", fast_norm=fast_norm), device="cpu")
    assert model.dtype == BF16
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {b.dtype for b in model.buffers()} == {torch.float32}
    computing = [m for m in model.modules()
                 if isinstance(m, (Linear, Conv2d, tnorms.LayerNorm,
                                   tnorms.GroupNorm, tnorms.FastLayerNorm,
                                   tnorms.FastGroupNorm))]
    assert computing and all(m.dtype == BF16 for m in computing)
    fast = [m for m in computing if isinstance(
        m, (tnorms.FastLayerNorm, tnorms.FastGroupNorm))]
    assert bool(fast) == fast_norm
    with torch.no_grad():
        out = model(torch.randn(1, 64, 96, 3), torch.zeros(1, 64, 96,
                                                           dtype=torch.bool))
    assert out["pred_logits"].dtype == BF16
    assert out["pred_boxes"].dtype == torch.float32
    assert torch.isfinite(out["pred_boxes"]).all()


def test_server_answers_with_a_bf16_model():
    """InferenceServer serves a bf16 model: f32 answers, finite, inside
    the image."""
    model = tdino.build_dino_from_config(
        dict(TINY, amp_dtype="bfloat16"), device="cpu")
    srv = InferenceServer(model, canvas_hw=(96, 128), batch_size=2,
                          num_select=10, score_threshold=0.0,
                          resize_short=96, resize_max=128, device="cpu")
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for hw in ((60, 80), (120, 90), (50, 50))]
    try:
        results = [f.result(timeout=120) for f in
                   [srv.submit(im) for im in imgs]]
    finally:
        srv.close()
    for im, r in zip(imgs, results):
        assert r["boxes"].dtype == np.float32 and r["boxes"].shape == (10, 4)
        assert np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"]).all()
        assert (r["scores"] >= 0).all() and (r["scores"] <= 1).all()
        assert (r["boxes"][:, 2] <= im.shape[1] + 1e-3).all()


@pytest.mark.parametrize("extra", [
    ["--amp"],  # a burn-in epoch
    # a self-training epoch (teacher, pseudo-labels, target criterion) and
    # the best-EMA evaluation, with the fast norms
    ["--options", "amp_dtype=bfloat16", "fast_norm=True", "burn_epochs=0"],
])
def test_main_runs_in_bf16(tmp_path, extra):
    """`python -m datr_torch.main --amp --device cpu` at
    tests/test_main_cli.py's tiny config: one epoch, a finite loss,
    datr_tpu's log.txt keys, and the checkpoint holding f32 parameters,
    optimizer moments and EMA tracks."""
    out = tmp_path / "out"
    _run(_cfg(tmp_path), out, *extra)
    lines = _log(out)
    assert len(lines) == 1
    ln = lines[0]
    keys = set(LOG_KEYS)
    if "burn_epochs=0" in extra:
        keys |= {"ap50_best_ema"}
        assert "train_num_pseudo" in ln
    assert {k for k in ln if not k.startswith("train_")} == keys
    assert np.isfinite(ln["train_loss"])
    saved = json.loads((out / "config_args_all.json").read_text())
    assert saved["amp_dtype"] == "bfloat16"
    payload = torch.load(out / "checkpoint", weights_only=False)
    for part in ("model", "ema_teacher", "best_ema", "model_ema"):
        assert {v.dtype for v in payload[part].values()} == {torch.float32}
    moments = [v for ps in payload["optimizer"]["state"].values()
               for k, v in ps.items() if k.startswith("exp_avg")]
    assert moments and {v.dtype for v in moments} == {torch.float32}
