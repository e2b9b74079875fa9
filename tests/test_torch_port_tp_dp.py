"""The port's data x tensor parallelism (datr_torch/parallel/mesh.py
`make_mesh(tp=2)` on 4 ranks: 'data' 2 x 'model' 2) against datr_tpu on the
CPU: four gloo ranks (tests/torch_port_dist_worker.py, spawned; no rank
imports JAX), each data shard 1 source + 1 target image of the global
batch.

- The burn-in step with DDP over 'data' against datr_tpu's step on the
  whole batch (its dp 4 x tp 2 step is its unsharded step,
  tests/test_parallel.py): losses, grad_norm, the whole gradients; the
  updated state equal on every rank, the matcher's assignments equal
  across 'model'.
- The same step with FSDP over 'data' (`fully_shard` of the local TP
  shards on the 'data' sub-mesh) against the DDP step.
- A checkpoint saved sharded on dp 2 x tp 2 restored on dp 1 x tp 4 and
  into one process (datr_tpu's tests/test_checkpoint_sharded.py:20-52,
  "save on dp4xtp2, restore on dp2xtp4"), and saved whole from rank 0.

The size is tests/test_torch_port_selftrain.py's, as in
tests/test_torch_port_dist.py."""

import os
import sys

import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch.models import dino as tdino
from datr_torch.train.checkpoint import load_checkpoint, load_checkpoint_sharded
from datr_torch.train.optim import Optimizer, param_group
from datr_torch.train.state import EMA_TRACKS, create_train_state
from datr_tpu.models import dino as jdino

sys.path.insert(0, os.path.dirname(__file__))
import torch_port_dist_worker as worker  # noqa: E402
from test_torch_port_dist import (  # noqa: E402
    LR,
    LR_BACKBONE,
    RANK_MEANS,
    STAGES,
    _grad_errors,
    _run as dist_run,
)

WORLD = 4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """datr_tpu's burn-in step on the global batch; on the ranks the DDP
    and FSDP steps and the checkpoint round; in this process the sharded
    and the whole checkpoint loaded into one model."""
    mp = pytest.MonkeyPatch()
    mp.setitem(jdino.RESNET_STAGES, "resnet50", STAGES)
    mp.setitem(tdino.RESNET_STAGES, "resnet50", STAGES)
    try:
        tmp = tmp_path_factory.mktemp("tp_dp")
        ckpt = str(tmp / "ckpt" / "sharded")

        def tasks(common):
            base = dict(common, st_draws=None, tp=2)
            return [("steps", base),
                    ("steps:fsdp", dict(base, fsdp=True)),
                    ("tp_ckpt", dict(
                        stages=STAGES, kw=common["kw"], sd=common["sd"],
                        lr=LR, lr_backbone=LR_BACKBONE,
                        batch=common["batch"], ccfg=common["ccfg"],
                        wd=common["wd"], draws=common["burnin_draws"],
                        save_to=ckpt))]

        out = dist_run(tmp / "ranks", tasks=tasks, world=WORLD,
                       self_training=False,
                       also=lambda common, *_: common["kw"])
        one = {}
        for name, load in (("sharded", load_checkpoint_sharded),
                           ("whole", load_checkpoint)):
            model = tdino.DINO(**out["one"])
            state = create_train_state(model, Optimizer(
                model, lr=LR, lr_backbone=LR_BACKBONE))
            state, meta = load(ckpt if name == "sharded" else ckpt + ".pt",
                               state)
            snap = worker._opt_snapshot(state)
            snap.update(worker._snapshot(state), step=state.step, meta=meta)
            one[name] = snap
        out["one"] = one
        yield out
    finally:
        mp.undo()


def test_dp_tp_ddp_step_equals_datr_tpu_global_step(run):
    """Every rank's losses are datr_tpu's at rtol 1e-5 / atol 1e-6,
    grad_norm and the rank-mean logging counts at rtol 1e-4 / atol 1e-5
    (the latter each data shard's own, averaged); the whole gradients
    within the step tests' bounds; all ranks' metrics equal."""
    want = run["jax"]["burnin"]
    ranks = [r["burnin"] for r in run["steps"]]
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
    for k, v in want["metrics"].items():
        if k.startswith(RANK_MEANS):
            continue
        tol = (dict(rtol=1e-5, atol=1e-6) if k.startswith("loss")
               else dict(rtol=1e-4, atol=1e-5))
        np.testing.assert_allclose(ranks[0]["metrics"][k], v, err_msg=k,
                                   **tol)
    worst = _grad_errors(ranks[0]["grads"], want["grads"])
    assert worst[1] <= 1.0, worst


def test_dp_tp_ranks_agree(run):
    """After the DDP step every rank's whole state (parameters, EMA
    tracks, global_proto, amount) is bitwise equal; the matcher's
    assignments are equal across 'model' (ranks 2d and 2d + 1) and differ
    across 'data' (other images)."""
    ranks = [r["burnin"] for r in run["steps"]]
    a0 = ranks[0]["after"]
    for r in ranks[1:]:
        for part in ("model", *EMA_TRACKS):
            for k, v in a0[part].items():
                assert torch.equal(v, r["after"][part][k]), (part, k)
        assert torch.equal(a0["global_proto"], r["after"]["global_proto"])
        assert torch.equal(a0["amount"], r["after"]["amount"])
    for d in (0, 2):
        m0, m1 = ranks[d]["matches"], ranks[d + 1]["matches"]
        assert len(m0) == len(m1) > 0
        for x, y in zip(m0, m1):
            assert all(torch.equal(u, v) for u, v in zip(x, y))
    assert not all(torch.equal(u, v) for x, y in zip(
        ranks[0]["matches"], ranks[2]["matches"]) for u, v in zip(x, y))


def test_dp_tp_fsdp_step_equals_ddp_step(run):
    """FSDP over 'data' of the local TP shards against DDP: metrics rtol
    1e-5, each gradient within 1e-4 of its norm (+ 1e-7 of the whole
    gradient's), the parameters after AdamW within 2 lr, the prototype
    state within f32 rounding; all ranks' gathered states equal."""
    d, f = run["steps"][0]["burnin"], run["steps:fsdp"][0]["burnin"]
    for k, v in d["metrics"].items():
        np.testing.assert_allclose(f["metrics"][k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    total = torch.stack([g.norm() for g in d["grads"].values()]).norm()
    for n, g in f["grads"].items():
        err = (g - d["grads"][n]).norm()
        assert err <= 1e-4 * d["grads"][n].norm() + 1e-7 * total, n
    for k, v in f["after"]["model"].items():
        tol = {"main": 2 * LR, "backbone": 2 * LR_BACKBONE}.get(
            param_group(k), 0.0) + 1e-6
        assert (v - d["after"]["model"][k]).abs().max() <= tol, k
    torch.testing.assert_close(f["after"]["global_proto"],
                               d["after"]["global_proto"], rtol=0, atol=1e-5)
    assert torch.equal(f["after"]["amount"], d["after"]["amount"])
    for r in run["steps:fsdp"][1:]:
        for part in ("model", *EMA_TRACKS):
            for k, v in f["after"][part].items():
                assert torch.equal(v, r["burnin"]["after"][part][k]), (part, k)


def _same(a, b):
    for part in ("model", *EMA_TRACKS):
        assert a[part].keys() == b[part].keys(), part
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    assert a["moments"].keys() == b["moments"].keys()
    for n, st in a["moments"].items():
        for k, v in st.items():
            assert torch.equal(v, b["moments"][n][k]), (n, k)
    assert torch.equal(a["global_proto"], b["global_proto"])
    assert torch.equal(a["amount"], b["amount"])
    assert a["step"] == b["step"] == 1


def test_checkpoint_dp2_tp2_restores_on_tp4_and_one_process(run):
    """The state saved sharded on dp 2 x tp 2, restored on dp 1 x tp 4
    and into one process, is bitwise the state that was saved
    (parameters, AdamW moments, EMA tracks, prototype state, step, meta);
    so is the whole checkpoint rank 0 wrote."""
    saved = run["tp_ckpt"][0]["saved"]
    for r in run["tp_ckpt"]:
        _same(r["saved"], saved)
        _same(r["loaded"], saved)
        assert r["loaded"]["meta"] == {"epoch": 5, "mesh": "dp2xtp2"}
    for name in ("sharded", "whole"):
        _same(run["one"][name], saved)
