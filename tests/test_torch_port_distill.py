"""The external distillation teacher of the port's self-training step
(`teacher=`, datr_tpu's `teacher_model` / `teacher_params`) and of its CLI
(`--distill_teacher_ckpt` / `--distill_teacher_config`) on the CPU.

The step: the mirror of tests/test_distill.py::
test_distill_step_uses_external_teacher, held against datr_tpu's own
train_step_self_training (jitted once, its optimizer a transformation
that hands the gradients back): a student with 2 sampling points per level
and a ResNet of one bottleneck block per stage (RESNET_STAGES patched on
both sides), labelled by a teacher with 4 points and the tiny Swin
backbone of tests/test_torch_port_backbones.py, so the two parameter trees
differ. Inputs and the threshold as in tests/test_torch_port_selftrain.py,
with its tolerances. The CLI: `datr_torch.main.main` in-process at
tests/test_torch_port_cli.py's tiny config, a burn-in and a self-training
epoch, the teacher a saved tiny Swin model of another configuration."""

import json
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # torch threads under xdist

from datr_torch.convert import (
    load_flax_params,
    load_flax_train_state,
    state_dict_from_flax,
)
from datr_torch.models import cdn as tcdn
from datr_torch.models import dino as tdino
from datr_torch.models.dino import DINO as TorchDINO
from datr_torch.train import criterion as tcrit
from datr_torch.train.optim import Optimizer, param_group
from datr_torch.train.state import EMA_TRACKS, create_train_state
from datr_torch.train.steps import (
    teacher_pseudo_labels,
    train_step_self_training,
)
from datr_tpu.models import dino as jdino
from datr_tpu.train import criterion as jcrit
from datr_tpu.train.state import create_train_state as jax_train_state
from datr_tpu.train.steps import (
    train_step_self_training as jax_train_step_self_training,
)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_backbones import (  # noqa: E402
    FAST_COMPILE,
    TINY_ENTRIES,
    backbone_params,
    register_tiny,
    train_tree_shapes,
)
from test_torch_port_selftrain import (  # noqa: E402
    CANVAS,
    K,
    _jax_cdn_draws,
    _stash_grads,
    _threshold,
    _tiny_batch,
    t,
)

HD = 32
STAGES = (1, 1, 1, 1)  # one bottleneck block per ResNet stage
DEC = 1  # tests/test_distill.py's depth
KW = dict(num_classes=K, num_queries=12, hidden_dim=HD, nheads=4,
          enc_layers=1, dec_layers=DEC, dim_feedforward=64, dn_number=4,
          dn_single_pad=2, dn_labelbook_size=K)


@pytest.fixture(scope="module")
def step():
    """datr_tpu's self-training step with the external teacher, and the
    port's from the same TrainState, teacher weights, thresholds and CDN
    draws; the port's gradients are taken as they accumulate."""
    mp = pytest.MonkeyPatch()
    mp.setitem(jdino.RESNET_STAGES, "resnet50", STAGES)
    mp.setitem(tdino.RESNET_STAGES, "resnet50", STAGES)
    swin = register_tiny(mp, "swin")
    try:
        yield _step(swin)
    finally:
        mp.undo()


def _step(swin):
    points = lambda p: dict(enc_n_points=p, dec_n_points=p)  # noqa: E731
    jstudent = jdino.DINO(**KW, **points(2), use_remat=False)
    jteacher = jdino.DINO(**KW, **points(4), backbone_name=swin,
                          use_remat=False)
    s_params = {"params": backbone_params(train_tree_shapes(jstudent), 1)}
    t_shapes = jax.eval_shape(lambda k: jteacher.init(
        k, jnp.zeros((1, *CANVAS, 3)), jnp.zeros((1, *CANVAS), bool),
        train=False), jax.random.PRNGKey(0))
    t_params = {"params": backbone_params(t_shapes["params"], 2)}
    n_leaves = [sum(x.size for x in jax.tree.leaves(p))
                for p in (s_params, t_params)]
    assert n_leaves[0] != n_leaves[1]

    batch = {k: jnp.asarray(v) for k, v in _tiny_batch().items()}
    tx = _stash_grads()
    js = jax.jit(lambda p: jax_train_state(p, tx, K, HD,
                                           jax.random.PRNGKey(3)))(s_params)
    ccfg = dict(num_classes=K, dn_single_pad=2, dn_groups=2)
    _, dn_rng = jax.random.split(js.rng)  # datr_tpu/train/steps.py:31-33

    # the port's models and states first: the step donates datr_tpu's
    student = TorchDINO(**KW, **points(2))
    state = load_flax_train_state(
        create_train_state(student, Optimizer(student)), js)
    teacher = TorchDINO(**KW, **points(4), backbone_name=swin).eval()
    assert load_flax_params(teacher, t_params) == [
        k for k in teacher.state_dict() if k.startswith(("d_img.",
                                                         "proto_d."))]
    teacher.requires_grad_(False)
    tb = {k: t(v) for k, v in _tiny_batch().items()}
    with torch.no_grad():  # the teacher's scores, as datr_tpu's to ~1e-7
        scores = teacher(tb["images"][2:], tb["pad_mask"][2:])[
            "pred_logits"].sigmoid()
    thr = np.full((K,), _threshold(scores), np.float32)
    before = {n: {k: v.clone() for k, v in m.state_dict().items()}
              for n, m in (("teacher", teacher), ("student", student),
                           *((n, getattr(state, n)) for n in EMA_TRACKS))}

    jstep = jax.jit(jax_train_step_self_training.__wrapped__,
                    static_argnames=("model", "tx", "ccfg", "canvas_hw",
                                     "num_select", "max_pseudo",
                                     "ema_decay", "teacher_model"),
                    compiler_options=FAST_COMPILE)
    new_js, metrics = jax.device_get(jstep(
        js, batch, jstudent, tx, jcrit.CriterionCfg(**ccfg),
        jcrit.build_weight_dict(dec_layers=DEC), jnp.asarray(thr),
        canvas_hw=CANVAS, teacher_model=jteacher, teacher_params=t_params))

    groups, _ = tcdn.cdn_layout(KW["dn_number"], KW["dn_single_pad"])
    draws = _jax_cdn_draws(dn_rng, 2, groups, KW["dn_single_pad"], K)
    thr_t = t(thr)
    ema_pseudo = teacher_pseudo_labels(state, tb, thr_t, CANVAS)
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.clone()))
        for n, p in student.named_parameters() if p.requires_grad]
    p_metrics = train_step_self_training(
        state, tb, tcrit.CriterionCfg(**ccfg),
        tcrit.build_weight_dict(dec_layers=DEC), thr_t, CANVAS,
        dn_draws=draws, teacher=teacher)
    for h in hooks:
        h.remove()
    return dict(jax=dict(metrics=metrics, grads=new_js.opt_state),
                port=dict(metrics=p_metrics, grads=grads, state=state,
                          teacher=teacher, before=before,
                          ema_pseudo=ema_pseudo))


def test_distill_step_losses(step):
    """num_pseudo equal (more than 0, fewer than every candidate), every
    loss (source and `_target`) rtol 1e-4 / atol 1e-5 and grad_norm rtol
    1e-4 (tests/test_torch_port_selftrain.py's bounds). The EMA teacher,
    which holds the student's weights, would have labelled another set."""
    want, got = step["jax"]["metrics"], step["port"]["metrics"]
    assert set(got) == set(want)
    assert 0 < int(got["num_pseudo"]) == int(want["num_pseudo"]) < 2 * 48
    ema_valid = step["port"]["ema_pseudo"][2]
    assert int(ema_valid.sum()) != int(got["num_pseudo"])
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_distill_step_gradients(step):
    """Every trainable gradient of the student by relative norm, rtol 1e-3,
    the backbone 1e-2, atol 1e-7 of the whole gradient's norm (the bounds
    and reasons of tests/test_torch_port_selftrain.py::
    test_self_training_step_gradients); the input projections' conv
    biases, whose gradient is zero in exact arithmetic, within 1e-6 of the
    whole gradient's norm of 0 on both sides (as in
    tests/test_torch_port_backbones.py's step). Measured: the last level's
    bias 1.0e-4 (datr_tpu) and 1.5e-5 (the port) against a bound of
    5.0e-4."""
    want = state_dict_from_flax(step["jax"]["grads"])
    got = step["port"]["grads"]
    student = step["port"]["state"].model
    assert set(got) == {n for n, p in student.named_parameters()
                        if p.requires_grad}
    atol = 1e-7 * torch.stack([want[n].norm() for n in got]).norm().item()
    for n, g in got.items():
        if n.startswith("input_proj") and n.endswith("_conv.bias"):
            # zero in exact arithmetic: in front of a GroupNorm of
            # one-channel groups (the last level's spans 1x2 pixels)
            assert max(g.norm(), want[n].norm()) <= 10 * atol, n
            continue
        rtol = 1e-2 if param_group(n) == "backbone" else 1e-3
        err = (g - want[n]).norm().item()
        assert err <= rtol * want[n].norm().item() + atol, (n, err)


def test_distill_step_moves_only_the_student(step):
    """The student's trainable parameters move; the teacher, the EMA
    teacher and the other EMA tracks keep every tensor (the tracks move per
    epoch, not per step); the teacher stays in eval mode without
    gradients."""
    port = step["port"]
    state, before = port["state"], port["before"]
    assert state.step == 1
    moved = [n for n, p in state.model.named_parameters() if p.requires_grad
             and not torch.equal(p, before["student"][n])]
    assert moved
    for name, m in (("teacher", port["teacher"]),
                    *((n, getattr(state, n)) for n in EMA_TRACKS)):
        for k, v in m.state_dict().items():
            assert torch.equal(v, before[name][k]), (name, k)
    assert not port["teacher"].training
    assert not any(p.requires_grad for p in port["teacher"].parameters())


# ---------------- the CLI ----------------


def test_distill_cli_flags_parse():
    """The port's flags parse as datr_tpu's (tests/test_distill.py::
    test_distill_cli_flags_parse)."""
    from datr_torch.main import get_args_parser

    args = get_args_parser().parse_args([
        "-c", "x.py", "--distill_teacher_ckpt", "/tmp/t",
        "--distill_teacher_config", "configs/DINO/DINO_4scale.py",
    ])
    assert args.distill_teacher_ckpt == "/tmp/t"
    assert args.distill_teacher_config.endswith("DINO_4scale.py")
    assert get_args_parser().parse_args(["-c", "x.py"]) \
        .distill_teacher_ckpt == ""


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_cli_self_training_with_distill_teacher(tmp_path, monkeypatch):
    """`main` at the CLI test's tiny config (a ResNet of one block per
    stage, 2 sampling points from `--options`) for one burn-in and one
    self-training epoch of 2 steps, `--distill_teacher_ckpt` a saved model
    of its own config (the tiny Swin backbone, 4 points) whose class biases
    were raised so that its scores clear the threshold: the teacher line is
    logged, the self-training epoch's log line has `train_num_pseudo` > 0
    (the seeded student's EMA teacher scores about 0.01, below the
    threshold 0.05, and would label nothing), and the teacher's config was
    read without the student's `--options` (else its checkpoint would not
    fit it)."""
    from test_torch_port_cli import TINY_CFG, _log, _run

    from datr_torch.config import load_config
    from datr_torch.models.dino import build_dino_from_config
    from datr_torch.train.checkpoint import save_checkpoint

    monkeypatch.setitem(tdino.RESNET_STAGES, "resnet50", STAGES)
    swin = register_tiny(monkeypatch, "swin")
    assert swin == TINY_ENTRIES["swin"][0]
    base = os.path.abspath("configs/DINO/DINO_4scale.py")
    cfg_path = tmp_path / "tiny_cfg.py"
    cfg_path.write_text(TINY_CFG.format(base=base))
    t_cfg_path = tmp_path / "teacher_cfg.py"
    t_cfg_path.write_text(TINY_CFG.format(base=base)
                          + f'backbone = "{swin}"\n')
    teacher = build_dino_from_config(load_config(str(t_cfg_path)), "cpu",
                                     seed=5)
    with torch.no_grad():
        teacher.class_head.bias.fill_(0.0)
    ckpt = tmp_path / "teacher"
    save_checkpoint(str(ckpt), teacher, 0)

    logger = logging.getLogger("datr_torch")
    msgs = _Messages()
    level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(msgs)
    out = tmp_path / "st"
    try:
        _run(str(cfg_path), out, "--distill_teacher_ckpt", str(ckpt),
             "--distill_teacher_config", str(t_cfg_path), "--options",
             "burn_epochs=1", "epochs=2", "enc_n_points=2", "dec_n_points=2",
             "save_checkpoint_interval=0")
    finally:
        logger.removeHandler(msgs)
        logger.setLevel(level)
    assert any(m == f"distillation teacher: {ckpt} ({t_cfg_path})"
               for m in msgs.lines), msgs.lines
    log = _log(out)
    assert [ln["epoch"] for ln in log] == [0, 1]
    assert "train_num_pseudo" not in log[0]
    assert log[1]["train_num_pseudo"] > 0
    assert all(np.isfinite(v) for v in log[1].values())
    cfg_all = json.loads((out / "config_args_all.json").read_text())
    assert cfg_all["enc_n_points"] == 2
