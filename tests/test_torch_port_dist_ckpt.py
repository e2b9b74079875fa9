"""Sharded checkpoints and the training CLI across processes, on the CPU
with two gloo ranks (tests/torch_port_dist_worker.py, spawned; no rank
imports JAX).

- torch.distributed.checkpoint: a state saved by one process loads into
  FSDP-sharded ranks, and the ranks' sharded save loads into one process
  (through `load_resume`, which reads either kind) and into DDP ranks, each
  bitwise: parameters, EMA tracks, AdamW moments, the prototype state and
  the counters; datr_tpu's save-on-one-layout, restore-on-another.
- `datr_torch.main` under a 2-rank process group at tests/test_main_cli.py's
  tiny config with `--device cpu`: one burn-in epoch, then an auto-resumed
  second. Rank 0 alone writes the checkpoint and log.txt, rank 1 logs to
  log.txt.rank1, and both log the same epoch line (the global means);
  after the resume each rank draws its own CDN noise again.

The model is tests/test_torch_port_selftrain.py's size with a ResNet of one
bottleneck block per stage, seeded."""

import json
import os
import sys

import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch.models import cdn as tcdn
from datr_torch.models import dino as tdino
from datr_torch.train import criterion as tcrit
from datr_torch.train.checkpoint import load_resume, save_checkpoint_sharded
from datr_torch.train.steps import train_step_burnin

sys.path.insert(0, os.path.dirname(__file__))
import torch_port_dist_worker as worker  # noqa: E402
from test_main_cli import _write_cfg  # noqa: E402
from test_torch_port_selftrain import KW, K, _tiny_batch, t  # noqa: E402

STAGES = (1, 1, 1, 1)
WORLD = 2
LR, LR_BACKBONE = 1e-4, 1e-5
CCFG = dict(num_classes=K, dn_single_pad=2, dn_groups=2)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setitem(tdino.RESNET_STAGES, "resnet50", STAGES)
    try:
        yield _run(tmp_path_factory.mktemp("dist_ckpt"))
    finally:
        mp.undo()


def _run(tmp):
    kw = dict(KW, dn_labelbook_size=K)
    model = tdino.DINO(**kw)
    model.init_params(torch.Generator().manual_seed(5))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    batch = {k: t(v) for k, v in _tiny_batch().items()
             if k != "images_strong"}
    groups, _ = tcdn.cdn_layout(KW["dn_number"], KW["dn_single_pad"])
    draws = tcdn.draw_cdn_noise(torch.Generator().manual_seed(1), 2, groups,
                                KW["dn_single_pad"], K, "cpu")
    wd = tcrit.build_weight_dict(dec_layers=2)
    # one process: a step (so that AdamW has moments), then a sharded save
    one = worker._state(kw, sd, LR, LR_BACKBONE)
    train_step_burnin(one, batch, tcrit.CriterionCfg(**CCFG), wd,
                      dn_draws=draws)
    save_checkpoint_sharded(str(tmp / "one"), one, 3, extra={"best": {}})
    saved_one = worker._opt_snapshot(one)
    saved_one.update(worker._snapshot(one), step=one.step)

    cfg = _write_cfg(tmp, **{"synthetic_images": 4})
    out = tmp / "cli"
    common = dict(stages=STAGES, kw=kw, sd=sd, lr=LR, lr_backbone=LR_BACKBONE)
    ctx = worker.spawn([
        ("dcp", dict(common, load_from=str(tmp / "one"),
                     save_to=str(tmp / "ranks"), batch=batch, ccfg=CCFG,
                     wd=wd, draws=draws)),
        ("cli:epoch0", dict(stages=STAGES, argv=[
            "-c", cfg, "--output_dir", str(out), "--synthetic", "--device",
            "cpu"])),
        ("cli:epoch1", dict(stages=STAGES, argv=[
            "-c", cfg, "--output_dir", str(out), "--synthetic", "--device",
            "cpu", "--options", "epochs=2"]))], WORLD, tmp / "spawn")
    worker.join(ctx)
    # one process loads the ranks' sharded save (FSDP on 2 ranks)
    back = worker._state(kw, sd, LR, LR_BACKBONE)
    back, start_epoch, meta = load_resume(str(tmp / "ranks"), back)
    loaded_one = worker._opt_snapshot(back)
    loaded_one.update(worker._snapshot(back), step=back.step)
    return dict(saved_one=saved_one, loaded_one=loaded_one,
                start_epoch=start_epoch, meta=meta,
                ranks=worker.results(tmp / "spawn", "dcp", WORLD), out=out,
                cli={run_: worker.results(tmp / "spawn", f"cli:{run_}", WORLD)
                     for run_ in ("epoch0", "epoch1")})


def _assert_states_equal(a, b):
    for part in ("model", "ema_teacher", "best_ema", "model_ema",
                 "moments"):
        assert a[part].keys() == b[part].keys(), part
        for k, v in a[part].items():
            if isinstance(v, dict):  # a parameter's moments
                assert v.keys() == b[part][k].keys(), (part, k)
                for m, x in v.items():
                    assert torch.equal(x, b[part][k][m]), (part, k, m)
            else:
                assert torch.equal(v, b[part][k]), (part, k)
    assert torch.equal(a["global_proto"], b["global_proto"])
    assert torch.equal(a["amount"], b["amount"])
    assert a["step"] == b["step"]


def test_one_process_checkpoint_loads_into_fsdp_ranks(run):
    """And moments taken before `shard_train_state(fsdp=True)` are carried
    into the sharded optimizer (Optimizer.rebind), gathered bitwise."""
    for r in run["ranks"]:
        assert r["rebound"]
        _assert_states_equal(r["loaded"], run["saved_one"])
        assert r["loaded"]["meta"] == {"epoch": 3, "best": {}}
    assert run["saved_one"]["moments"]  # AdamW moments were saved


def test_fsdp_checkpoint_loads_into_one_process_and_ddp(run):
    """The ranks' save (after one more FSDP step) loads bitwise into one
    process through load_resume, whose start epoch follows the meta, and
    into DDP ranks."""
    saved = run["ranks"][0]["saved"]
    _assert_states_equal(run["ranks"][1]["saved"], saved)
    _assert_states_equal(run["loaded_one"], saved)
    assert saved["step"] == 2
    assert run["start_epoch"] == 6 and run["meta"] == {"epoch": 5,
                                                       "ranks": WORLD}
    for r in run["ranks"]:
        _assert_states_equal(r["ddp_loaded"], saved)


def _epoch_lines(path):
    """The epoch JSON lines of a log file: the file's own lines starting
    with '{', or the logger's lines whose message is one."""
    lines = []
    for ln in open(path):
        msg = ln.split(": ", 1)[1] if ln.startswith("[") else ln
        if msg.startswith("{\"epoch\""):
            lines.append(json.loads(msg))
    return lines


def test_cli_across_two_ranks(run):
    """Rank 0 writes the checkpoints, config_args_all.json and log.txt's
    epoch lines (one per epoch: no second writer), rank 1 only its
    log.txt.rank1; both log the same epoch lines but for their wall times,
    so the logged losses and APs are the global ones; the second run
    resumed at epoch 1 on both ranks."""
    out = run["out"]
    files = set(os.listdir(out))
    assert {"checkpoint", "checkpoint0000", "checkpoint0001", "log.txt",
            "log.txt.rank1", "config_args_all.json",
            "best_ema_teacher"} <= files, files
    assert not any("rank1" in f for f in files - {"log.txt.rank1"})
    mine = [json.loads(ln) for ln in open(out / "log.txt")
            if ln.startswith("{")]
    assert [ln["epoch"] for ln in mine] == [0, 1]
    def same(lines):  # but each rank's own wall time
        return [{k: v for k, v in ln.items() if k != "time"}
                for ln in lines]

    assert same(_epoch_lines(out / "log.txt.rank1")) == same(mine)
    assert all(np.isfinite(ln["train_loss"]) for ln in mine)
    rank1 = open(out / "log.txt.rank1").read()
    assert "process 1 of 2 on cpu" in rank1
    assert "process 1 of 2" not in open(out / "log.txt").read()


def test_resumed_ranks_draw_their_own_cdn_noise(run):
    """Each rank draws its own CDN noise (seed + rank), in the first run
    and after the second run's auto-resume, although the checkpoint holds
    rank 0's generator alone."""
    for name in ("epoch0", "epoch1"):
        r0, r1 = (r["dn_generator"] for r in run["cli"][name])
        assert not torch.equal(r0, r1), name
