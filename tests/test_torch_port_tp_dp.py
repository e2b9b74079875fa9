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
- Sharded checkpoints of dp 2 x tp 2 with FSDP, dp 2 x tp 2 with DDP (the
  one above) and dp 4 with FSDP, each restored on dp 2 x tp 2 with FSDP,
  the first also on dp 1 x tp 4 and each into one process, bitwise; at
  this size every FSDP piece of a rank's MHA in_proj rows crosses a q / k
  / v boundary. A fresh state's checkpoint resumed on dp 2 x tp 2 with
  FSDP steps as datr_tpu's global step and bitwise as the unrestored FSDP
  step.

The size is tests/test_torch_port_selftrain.py's, as in
tests/test_torch_port_dist.py."""

import os
import sys

import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch.models import dino as tdino
from datr_torch.parallel.mesh import TPSplit, shard_tensor
from datr_torch.train import checkpoint as ckpt
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
        layouts = str(tmp / "layouts")

        def tasks(common):
            base = dict(common, st_draws=None, tp=2)
            return [("steps", base),
                    ("steps:fsdp", dict(base, fsdp=True)),
                    ("tp_ckpt", dict(
                        stages=STAGES, kw=common["kw"], sd=common["sd"],
                        lr=LR, lr_backbone=LR_BACKBONE,
                        batch=common["batch"], ccfg=common["ccfg"],
                        wd=common["wd"], draws=common["burnin_draws"],
                        save_to=ckpt)),
                    ("tp_fsdp_ckpt", dict(
                        stages=STAGES, kw=common["kw"], sd=common["sd"],
                        lr=LR, lr_backbone=LR_BACKBONE,
                        batch=common["batch"], ccfg=common["ccfg"],
                        wd=common["wd"], draws=common["burnin_draws"],
                        save_to=layouts, tp_ddp=ckpt))]

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
        for name in ("tp_fsdp", "fsdp"):  # into one process
            model = tdino.DINO(**out["one"])
            state, meta = load_checkpoint_sharded(f"{layouts}/{name}",
                                                  create_train_state(
                model, Optimizer(model, lr=LR, lr_backbone=LR_BACKBONE)))
            snap = worker._opt_snapshot(state)
            snap.update(worker._snapshot(state), step=state.step, meta=meta)
            one[f"{name}->one"] = worker._digest(snap)
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


def _eq(a, b) -> bool:
    """Bitwise: two tensors, or two `worker._digest`s of tensors."""
    return torch.equal(a, b) if torch.is_tensor(a) else a == b


def _same(a, b):
    for part in ("model", *EMA_TRACKS):
        assert a[part].keys() == b[part].keys(), part
        for k, v in a[part].items():
            assert _eq(v, b[part][k]), (part, k)
    assert a["moments"].keys() == b["moments"].keys()
    for n, st in a["moments"].items():
        for k, v in st.items():
            assert _eq(v, b["moments"][n][k]), (n, k)
    assert _eq(a["global_proto"], b["global_proto"])
    assert _eq(a["amount"], b["amount"])
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


@pytest.mark.parametrize("src,dst", [
    ("tp_fsdp", "tp4"), ("tp_fsdp", "tp_fsdp"), ("tp_fsdp", "one"),
    ("tp_ddp", "tp_fsdp"), ("fsdp", "tp_fsdp"), ("fsdp", "one")])
def test_tp_fsdp_checkpoints_restore_across_layouts(run, src, dst):
    """The state saved sharded on layout `src` (after one step; "tp_ddp"
    is the checkpoint of test_checkpoint_dp2_tp2_restores_on_tp4_and_one_
    process, which loads it into one process), restored on layout `dst`,
    is bitwise the state that was saved: parameters, AdamW moments, EMA
    tracks, prototype state, step and meta; equal on every rank."""
    saved = [worker._digest(r["saved"]) for r in run["tp_ckpt"]] \
        if src == "tp_ddp" else [r["saved"][src] for r in run["tp_fsdp_ckpt"]]
    for r in saved:
        _same(r, saved[0])
    saved = saved[0]
    got = ([run["one"][f"{src}->one"]] if dst == "one" else
           [r["loaded"][f"{src}->{dst}"] for r in run["tp_fsdp_ckpt"]])
    meta = ({"epoch": 5, "mesh": "dp2xtp2"} if src == "tp_ddp"
            else {"epoch": 5, "kind": src})
    for g in got:
        _same(g, saved)
        assert g["meta"] == meta


def test_tp_fsdp_resumed_step_equals_datr_tpu_global_step(run):
    """A fresh dp 4 FSDP state's checkpoint, resumed on dp 2 x tp 2 with
    FSDP (epoch 0 + 1), takes datr_tpu's global burn-in step (the
    tolerances of test_dp_tp_ddp_step_equals_datr_tpu_global_step) and
    leaves the state of the same ranks' step without a checkpoint, bit
    for bit: the moments the save made by AdamW's step at lr 0 carry no
    step count."""
    want = run["jax"]["burnin"]
    got = [r["resumed"] for r in run["tp_fsdp_ckpt"]]
    for r in got:
        assert r["epoch"] == 1 and r["metrics"] == got[0]["metrics"]
    for k, v in want["metrics"].items():
        if k.startswith(RANK_MEANS):
            continue
        tol = (dict(rtol=1e-5, atol=1e-6) if k.startswith("loss")
               else dict(rtol=1e-4, atol=1e-5))
        np.testing.assert_allclose(got[0]["metrics"][k], v, err_msg=k,
                                   **tol)
    worst = _grad_errors(got[0]["grads"], want["grads"])
    assert worst[1] <= 1.0, worst
    for r, f in zip(got, run["steps:fsdp"]):
        after = worker._digest(f["burnin"]["after"])
        for part in ("model", *EMA_TRACKS):
            assert r["after"][part] == after[part], part


@pytest.mark.parametrize("whole,split,tp,dp", [
    ((768, 256), TPSplit(0, 3), 2, 2), ((96, 32), TPSplit(0, 3), 4, 1),
    ((96, 32), TPSplit(0, 3), 2, 3), ((256, 2048), TPSplit(1), 2, 3),
    ((2048,), TPSplit(0), 4, 3), ((10, 6), TPSplit(0), 2, 4)])
def test_sharded_checkpoint_rectangles_tile_the_whole(whole, split, tp, dp):
    """Every rank's rectangles (`checkpoint._rects`) tile the whole tensor
    once, and each holds the whole tensor's values at its offsets: rank
    (d, t)'s local tensor is FSDP's dim-0 chunk d of TP shard t (uneven
    chunks, short or empty, included). d = 256 on dp 2 x tp 2 cuts the
    local [384, 256] in two pieces of 192 rows, each crossing a q / k / v
    boundary, so each is two rectangles."""
    full = torch.arange(int(np.prod(whole))).reshape(whole)
    seen = torch.zeros(whole, dtype=torch.int64)
    for t in range(tp):
        shard = shard_tensor(full, split, t, tp)
        pieces = torch.chunk(shard, dp, 0)
        for d in range(dp):
            local = pieces[d] if d < len(pieces) else shard[:0]
            rects = ckpt._rects(list(whole), split, t, tp, d, dp)
            assert sum(r[1][0] for r in rects) == len(local)
            for off, size, row in rects:
                idx = tuple(slice(o, o + n) for o, n in zip(off, size))
                assert torch.equal(full[idx], local[row:row + size[0]])
                seen[idx] += 1
            if whole == (768, 256) and split.chunks == 3:
                assert len(rects) == 2
    assert bool((seen == 1).all())
