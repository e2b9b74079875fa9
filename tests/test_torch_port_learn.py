"""The port's learnability mirrors and its distillation tools on the CPU.

- Mirrors of the three slow-marked learnability tests (tests/
  test_e2e_smoke.py:31, test_e2e_self_training.py:35, test_e2e_distill.py:
  87) through the port's own data pipeline, steps and evaluation, at their
  sizes and thresholds, marked slow as they are. Each model starts from
  the original's own weights: datr_tpu's flax init at its PRNGKey and
  first batch, converted (`state_dict_from_flax`); the CDN noise is the
  port's generator's.
- `datr_torch.tools.distill_retention --device cpu --tiny` and
  `datr_torch.tools.distill_flagship --device cpu --tiny` in this process
  at a small canvas and a few steps, a ResNet of one block per stage
  (RESNET_STAGES patched): every phase prints the JAX tool's record keys
  (tools/distill_retention.py, tools/distill_flagship.py), with finite
  losses and AP50 in [0, 1].

A 2-point student's burn-in and teacher-labelled steps against datr_tpu's
are tests/test_torch_port_distill.py's (P = 2 student, P = 4 teacher)."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch.convert import state_dict_from_flax
from datr_torch.data.coco import DAPairedDataset
from datr_torch.data.loader import make_da_loader, make_eval_loader, to_device
from datr_torch.data.synthetic import (
    SyntheticDetectionDataset,
    synthetic_da_pair,
)
from datr_torch.data.transforms import DATrainTransform, EvalTransform
from datr_torch.engine import evaluate, update_emas_per_epoch
from datr_torch.models import dino as tdino
from datr_torch.models.dino import DINO
from datr_torch.tools import distill_flagship, distill_retention
from datr_torch.train.criterion import CriterionCfg, build_weight_dict
from datr_torch.train.optim import Optimizer
from datr_torch.train.state import create_train_state
from datr_torch.train.steps import train_step_burnin, train_step_self_training
from datr_tpu.models.dino import DINO as JaxDINO

CANVAS = (96, 128)
CPU = torch.device("cpu")
BURNIN_KEYS = distill_retention.BURNIN_KEYS


def _model(k, batch0, points=4, seed=0):
    """The originals' model (tests/test_e2e_*.py) with the weights of
    datr_tpu's init at PRNGKey(seed) on `batch0`; the frozen BN statistics
    at their identity init, as flax's."""
    kw = dict(num_classes=k, num_queries=16, hidden_dim=32, nheads=4,
              enc_layers=1, dec_layers=2, dim_feedforward=64, dn_number=4,
              dn_single_pad=4, dn_labelbook_size=k, enc_n_points=points,
              dec_n_points=points, use_remat=False)
    params = JaxDINO(**kw).init(
        jax.random.PRNGKey(seed), jnp.asarray(batch0["images"]),
        jnp.asarray(batch0["pad_mask"]),
        targets={n: jnp.asarray(batch0[n]) for n in ("boxes", "labels",
                                                     "valid")},
        dn_rng=jax.random.PRNGKey(seed + 1), train=True,
        global_proto=jnp.zeros((k, 32)), amount=jnp.zeros((k,)))
    model = DINO(**kw)
    model.init_params(torch.Generator().manual_seed(seed))
    missing, unexpected = model.load_state_dict(
        state_dict_from_flax(jax.device_get(params)), strict=False)
    assert not unexpected and all("running_" in n for n in missing), (
        missing, unexpected)
    return model


def _state(model, lr, seed):
    return create_train_state(model, Optimizer(model, lr=lr,
                                               lr_backbone=lr / 10),
                              seed=seed + 2)


def _loader_factory(ds):
    tf = DATrainTransform(scales=[72, 80], max_size=120,
                          scales2_resize=[64, 72], scales2_crop=[48, 72])

    def loader(epoch, seed=0):
        return make_da_loader(ds, 2, CANVAS, tf, max_boxes=8, seed=seed,
                              epoch=epoch, num_threads=2)

    return loader


def _burnin(state, batch, ccfg, wd):
    return train_step_burnin(state, to_device(batch, CPU, BURNIN_KEYS),
                             ccfg, wd)


def _ap50(model, loader, cats) -> float:
    return float(evaluate(model.eval(), loader, cats)["ap50"])


@pytest.mark.slow
def test_burnin_learns_on_synthetic():
    """tests/test_e2e_smoke.py:31: six burn-in epochs on synthetic
    rectangles cut the loss by 10%; the evaluation runs (12 stats)."""
    k = 5
    loader = _loader_factory(synthetic_da_pair(n_images=8, hw=(80, 112),
                                               num_classes=k - 1))
    model = _model(k, next(iter(loader(0))))
    state = _state(model, 2e-4, seed=0)
    ccfg = CriterionCfg(num_classes=k, dn_single_pad=4, dn_groups=1)
    wd = build_weight_dict(dec_layers=2)
    losses = []
    for epoch in range(6):
        for batch in loader(epoch):
            losses.append(float(_burnin(state, batch, ccfg, wd)["loss"]))
        update_emas_per_epoch(state, epoch, {
            "ema_decay_teacher": 0.9, "epochs": 6, "burn_epochs": 0,
            "ema_decay_best_model": 0.5})
    assert np.isfinite(losses).all()
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    assert last < first * 0.9, (first, last)
    val = SyntheticDetectionDataset(4, hw=(80, 112), num_classes=k - 1,
                                    seed=3)
    ev_loader = make_eval_loader(val, 2, CANVAS, EvalTransform(80, 120),
                                 max_boxes=8)
    stats = evaluate(state.model.eval(), ev_loader, val.categories)
    assert len(stats["coco_eval_bbox"]) == 12


@pytest.mark.slow
def test_self_training_improves_target_domain():
    """tests/test_e2e_self_training.py:35: after four burn-in epochs, six
    self-training epochs emit pseudo-labels and do not lower the student's
    target-domain AP50; the EMA teacher evaluates."""
    k = 5
    ema_cfg = {"ema_decay_teacher": 0.6, "epochs": 10, "burn_epochs": 4,
               "ema_decay_best_model": 0.5}
    loader = _loader_factory(synthetic_da_pair(n_images=8, hw=(80, 112),
                                               num_classes=k - 1))
    model = _model(k, next(iter(loader(0))))
    state = _state(model, 2e-4, seed=0)
    ccfg = CriterionCfg(num_classes=k, dn_single_pad=4, dn_groups=1)
    wd = build_weight_dict(dec_layers=2)
    for epoch in range(4):
        for batch in loader(epoch):
            _burnin(state, batch, ccfg, wd)
        update_emas_per_epoch(state, epoch, ema_cfg)
    val = SyntheticDetectionDataset(6, hw=(80, 112), num_classes=k - 1,
                                    seed=11, fog=0.35)
    ev_loader = make_eval_loader(val, 2, CANVAS, EvalTransform(80, 120),
                                 max_boxes=8)
    ap_burn = _ap50(state.model, ev_loader, val.categories)
    thr = torch.full((k,), 0.2)
    pseudo, losses = [], []
    for epoch in range(4, 10):
        for batch in loader(epoch):
            m = train_step_self_training(state, to_device(batch, CPU), ccfg,
                                         wd, thr, canvas_hw=CANVAS,
                                         num_select=16, max_pseudo=8)
            pseudo.append(int(m["num_pseudo"]))
            losses.append(float(m["loss"]))
        update_emas_per_epoch(state, epoch, ema_cfg)
    assert np.isfinite(losses).all()
    assert sum(pseudo) > 0 and max(pseudo[-len(pseudo) // 2:]) > 0
    ap_st = _ap50(state.model, ev_loader, val.categories)
    assert ap_st >= ap_burn, (ap_burn, ap_st)
    assert np.isfinite(_ap50(state.ema_teacher, ev_loader, val.categories))


@pytest.mark.slow
def test_distillation_preserves_fast_config_accuracy():
    """tests/test_e2e_distill.py:87: a 4-point teacher trained with labels
    on the fog domain, distilled into a 2-point student (burn-in on clear
    labels, then the teacher's pseudo-labels on fog) keeps 0.75 of the
    teacher's fog AP50 and beats the from-scratch 2-point run by 0.25."""
    k, fog, epochs, lr = 3, 0.55, 80, 5e-4
    clear = SyntheticDetectionDataset(8, hw=(80, 112), num_classes=k - 1,
                                      max_objects=2, seed=0)
    fogged = SyntheticDetectionDataset(8, hw=(80, 112), num_classes=k - 1,
                                       max_objects=2, seed=1, fog=fog)
    ccfg = CriterionCfg(num_classes=k, dn_single_pad=4, dn_groups=1)
    wd = build_weight_dict(dec_layers=2)
    val = SyntheticDetectionDataset(6, hw=(80, 112), num_classes=k - 1,
                                    max_objects=2, seed=11, fog=fog)
    ev_loader = make_eval_loader(val, 2, CANVAS, EvalTransform(80, 120),
                                 max_boxes=8)

    t_loader = _loader_factory(DAPairedDataset(fogged, fogged))
    batch0 = next(iter(t_loader(0)))
    teacher = _model(k, batch0, points=4, seed=0)
    t_state = _state(teacher, lr, seed=0)
    for epoch in range(epochs):
        for batch in t_loader(epoch):
            _burnin(t_state, batch, ccfg, wd)
    ap_teacher = _ap50(teacher, ev_loader, val.categories)

    da_loader = _loader_factory(DAPairedDataset(clear, fogged))
    d_state = _state(_model(k, batch0, points=2, seed=10), lr, seed=10)
    thr = torch.full((k,), 0.45)
    pseudo = []
    for epoch in range(epochs // 2):
        for batch in da_loader(epoch, seed=1):
            _burnin(d_state, batch, ccfg, wd)
    for epoch in range(epochs // 2, epochs):
        for batch in da_loader(epoch, seed=1):
            m = train_step_self_training(
                d_state, to_device(batch, CPU), ccfg, wd, thr,
                canvas_hw=CANVAS, num_select=16, max_pseudo=8,
                teacher=teacher.eval())
            pseudo.append(int(m["num_pseudo"]))
    ap_distilled = _ap50(d_state.model, ev_loader, val.categories)

    s_state = _state(_model(k, batch0, points=2, seed=10), lr, seed=10)
    for epoch in range(epochs):
        for batch in da_loader(epoch, seed=1):
            _burnin(s_state, batch, ccfg, wd)
    ap_scratch = _ap50(s_state.model, ev_loader, val.categories)
    print(f"\n[distill e2e, port] teacher(P=4) ap50={ap_teacher:.3f}  "
          f"distilled(P=2) ap50={ap_distilled:.3f}  scratch(P=2) "
          f"ap50={ap_scratch:.3f}  pseudo={sum(pseudo)}")
    assert ap_teacher > 0.3, f"teacher failed to learn: {ap_teacher}"
    assert sum(pseudo) > 0
    assert ap_distilled >= 0.75 * ap_teacher, (ap_teacher, ap_distilled)
    assert ap_distilled >= ap_scratch + 0.25, (ap_scratch, ap_distilled)


# ------------------------------------------------------------ the tools

SMALL = ["--device", "cpu", "--tiny", "--batch", "1", "--canvas", "96",
         "128"]
# the keys of each record the JAX tools print (tools/distill_retention.py,
# tools/distill_flagship.py), by phase / stage
RETENTION_KEYS = {
    "teacher": {"phase", "steps", "train_s"},
    "teacher_eval": {"phase", "ap50"},
    "student_burnin": {"phase", "steps", "train_s"},
    "student_distill": {"phase", "steps", "pseudo", "train_s"},
    "student_eval": {"phase", "ap50"},
    "scratch": {"phase", "steps", "train_s"},
    "scratch_eval": {"phase", "ap50"},
    "retention": {"retention", "ap50_teacher", "ap50_student", "steps",
                  "canvas", "classes", "fog", "arch", "pseudo_total",
                  "ap50_scratch"},
}
BURNIN_STAGE = {"stage", "epoch", "steps", "loss", "ce", "cls_err", "giou",
                "sec"}
FLAGSHIP_KEYS = {
    "setup": {"stage", "devices", "epochs", "n_train", "canvas"},
    "init": {"stage", "arch", "sec", "params"},
    "teacher": BURNIN_STAGE, "distill_burnin": BURNIN_STAGE,
    "scratch": BURNIN_STAGE,
    "distill_selftrain": {"stage", "epoch", "steps", "loss",
                          "last_step_pseudo", "sec"},
    "eval": {"stage", "arch", "ap50", "ap"},
    "result": {"stage", "teacher_ap50", "distilled_ap50", "scratch_ap50",
               "retention", "pseudo_last_steps", "width", "probe"},
}


def _records(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


@pytest.fixture
def small_backbone(monkeypatch):
    monkeypatch.setitem(tdino.RESNET_STAGES, "resnet50", (1, 1, 1, 1))


def test_distill_retention_tiny_prints_the_jax_records(small_backbone,
                                                       capsys):
    """`--device cpu --tiny --scratch` for 4 steps: the phases in the JAX
    tool's order, each record with its keys (and the port's launch and
    timing keys on the training phases: no MSDA kernel on the CPU),
    finite losses, AP50 and retention in range."""
    out = distill_retention.main(SMALL + [
        "--steps", "4", "--hw", "80", "112", "--images", "2",
        "--val_images", "2", "--scratch"])
    recs = _records(capsys)
    phases = [r.get("phase", "retention") for r in recs]
    assert phases == list(RETENTION_KEYS), phases
    for r, phase in zip(recs, phases):
        assert RETENTION_KEYS[phase] <= set(r), (phase, r)
        if "train_s" in r:
            assert math.isfinite(r["loss"]) and r["steps"] >= 2
            assert r["msda_fwd_launches"] == r["msda_bwd_launches"] == 0
            assert r["clock"] == "host" and r["step_s"] > 0
        if "ap50" in r:
            assert 0.0 <= r["ap50"] <= 1.0
    assert [r["steps"] for r in recs if "train_s" in r] == [4, 2, 2, 4]
    assert recs[-1]["retention"] == pytest.approx(out["retention"],
                                                  abs=1e-4)
    assert out["arch"] == "tiny" and 0.0 <= out["ap50_student"] <= 1.0


def test_distill_flagship_tiny_prints_the_jax_records(small_backbone,
                                                      capsys):
    """`--device cpu --tiny` for 2 epochs of 2 images: every stage of the
    JAX tool with its keys, finite losses, AP50 in [0, 1]."""
    out = distill_flagship.main(SMALL + [
        "--epochs", "2", "--n_train", "2", "--n_val", "2", "--img_hw", "80",
        "112"])
    recs = _records(capsys)
    stages = [r["stage"] for r in recs]
    assert stages == ["setup", "init", "teacher", "teacher", "eval",
                      "distill_burnin", "distill_selftrain", "eval",
                      "scratch", "scratch", "eval", "result"], stages
    for r in recs:
        assert FLAGSHIP_KEYS[r["stage"]] <= set(r), r
        if "loss" in r:
            assert math.isfinite(r["loss"]) and r["steps"] == 2
        if "ap50" in r:
            assert 0.0 <= r["ap50"] <= 1.0
    assert out["width"].startswith("32/") and out["probe"] is False
