"""The port's data-parallel training against datr_tpu on the CPU: two gloo
ranks (tests/torch_port_dist_worker.py, spawned; no rank imports JAX) each
take their share of a global batch of 2 source + 2 target images, the
student in DDP, and their burn-in and self-training steps are held against
datr_tpu's step on the whole global batch (its cross-device training is a
mesh step whose result is the unsharded step's, tests/test_parallel.py).
Then the same burn-in step with FSDP (`fully_shard`) against the DDP step.

The size is tests/test_torch_port_selftrain.py's (hidden 32, 1 + 2 layers,
12 queries, 64x96), with a ResNet of one bottleneck block per stage
(RESNET_STAGES patched on both sides) and datr_tpu's parameters drawn with
numpy over `jax.eval_shape`'s tree. datr_tpu's steps run with an optax
transformation that hands the gradients back (test_torch_port_selftrain.py
`_stash_grads`), jitted once each at XLA's lowest optimization level, while
the ranks run. Each rank takes its slice of datr_tpu's CDN draws."""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch.convert import state_dict_from_flax
from datr_torch.models import cdn as tcdn
from datr_torch.models import dino as tdino
from datr_torch.train import criterion as tcrit
from datr_torch.train.optim import param_group
from datr_torch.train.state import EMA_TRACKS
from datr_tpu.models import dino as jdino
from datr_tpu.train import criterion as jcrit
from datr_tpu.train.state import create_train_state as jax_train_state
from datr_tpu.train.steps import train_step_burnin as jax_burnin
from datr_tpu.train.steps import (
    train_step_self_training as jax_self_training,
)

sys.path.insert(0, os.path.dirname(__file__))
import torch_port_dist_worker as worker  # noqa: E402
from test_torch_port_backbones import (  # noqa: E402
    FAST_COMPILE,
    backbone_params,
    train_tree_shapes,
)
from test_torch_port_selftrain import (  # noqa: E402
    CANVAS,
    HD,
    KW,
    K,
    _jax_cdn_draws,
    _stash_grads,
    _threshold,
    _tiny_batch,
    t,
)

STAGES = (1, 1, 1, 1)
WORLD = 2
LR, LR_BACKBONE = 1e-4, 1e-5
CCFG = dict(num_classes=K, dn_single_pad=2, dn_groups=2)
# logging-only counts (every layer's): each rank's over its own images, then
# averaged as the reference's reduce_dict does; not the global batch's
RANK_MEANS = ("class_error", "cardinality_error")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' DDP burn-in and self-training steps and FSDP burn-in
    step, and datr_tpu's two steps on the global batch, from the same
    parameters, draws and threshold."""
    mp = pytest.MonkeyPatch()
    mp.setitem(jdino.RESNET_STAGES, "resnet50", STAGES)
    mp.setitem(tdino.RESNET_STAGES, "resnet50", STAGES)
    try:
        yield _run(tmp_path_factory.mktemp("dist"))
    finally:
        mp.undo()


def _run(tmp, tasks=None, world=WORLD, also=None, self_training=True):
    """datr_tpu's two steps (or only the burn-in step) on the global batch
    while the ranks run `tasks(common)` (default: the DDP steps and the
    FSDP burn-in step) on `world` ranks, and `also(common)` in this
    process. Returns the JAX steps under "jax", each task's results by
    task name ("ddp" / "fsdp" for the default ones) and what
    `also(common, datr_tpu's model, its params)` returned under "one"."""
    jm = jdino.DINO(**KW, dn_labelbook_size=K, use_remat=False)
    params = {"params": backbone_params(train_tree_shapes(jm, CANVAS), 4)}
    tx = _stash_grads()
    js = jax_train_state(params, tx, K, HD, jax.random.PRNGKey(3))
    _, dn_rng = jax.random.split(js.rng)  # datr_tpu/train/steps.py:31-33
    groups, _ = tcdn.cdn_layout(KW["dn_number"], KW["dn_single_pad"])
    draws = _jax_cdn_draws(dn_rng, 2, groups, KW["dn_single_pad"], K)
    sd = state_dict_from_flax(params)
    kw = dict(KW, dn_labelbook_size=K)
    teacher = tdino.DINO(**kw).eval()
    teacher.load_state_dict(sd)
    tb = {k: t(v) for k, v in _tiny_batch().items()}
    with torch.no_grad():  # one process: the teacher's scores
        scores = teacher(tb["images"][2:], tb["pad_mask"][2:])[
            "pred_logits"].sigmoid()
    thr = np.full((K,), _threshold(scores), np.float32)
    common = dict(stages=STAGES, kw=kw, sd=sd, batch=tb, ccfg=CCFG,
                  wd=tcrit.build_weight_dict(dec_layers=2),
                  burnin_draws=draws, thr=torch.from_numpy(thr),
                  canvas=CANVAS, lr=LR, lr_backbone=LR_BACKBONE)
    task_list = ([("steps", dict(common, st_draws=draws)),
                  ("steps:fsdp", dict(common, st_draws=None, fsdp=True))]
                 if tasks is None else tasks(dict(common, st_draws=draws)))
    ctx = worker.spawn(task_list, world, tmp)
    try:  # datr_tpu's global steps while the ranks run
        batch = {k: jnp.asarray(v) for k, v in _tiny_batch().items()}
        ccfg, wd = jcrit.CriterionCfg(**CCFG), jcrit.build_weight_dict(
            dec_layers=2)
        static = ("model", "tx", "ccfg", "canvas_hw", "num_select",
                  "max_pseudo", "ema_decay", "teacher_model")
        def run_step(fn, extra):
            step = jax.jit(fn.__wrapped__, compiler_options=FAST_COMPILE,
                           static_argnames=[a for a in static
                                            if a in fn.__wrapped__.__code__
                                           .co_varnames])
            new, metrics = jax.device_get(step(
                jax.tree.map(jnp.copy, js), batch, jm, tx, ccfg, wd, **extra))
            return dict(metrics=metrics, state=new,
                        grads=state_dict_from_flax(new.opt_state))

        # both steps compile at once (XLA releases the GIL)
        with ThreadPoolExecutor(2) as pool:
            fns = (jax_burnin, jax_self_training)[:1 + self_training]
            jax_steps = pool.map(
                run_step, fns,
                ({}, dict(class_thresholds=jnp.asarray(thr),
                          canvas_hw=CANVAS)))
            one = (also(dict(common, st_draws=draws), jm, params) if also
                   else None)
            jax_steps = dict(zip(("burnin", "self_training"), jax_steps))
    finally:
        worker.join(ctx)
    res = {name: worker.results(tmp, name, world) for name, _ in task_list}
    if tasks is None:
        return dict(jax=jax_steps, ddp=res["steps"], fsdp=res["steps:fsdp"])
    return dict(jax=jax_steps, one=one, **res)


def _grad_errors(got, want):
    """Per tensor |g - g_want| against rtol |g_want| + 1e-7 |G_want|
    (test_torch_port_selftrain.py's gradient bounds: rtol 1e-3, the
    backbone 1e-2): the largest ratio, <= 1 passes. datr_tpu's entries
    that the port has no gradient for are the frozen group's (its frozen
    norms are buffers here)."""
    assert all(param_group(n) == "frozen" for n in set(want) - set(got))
    want = {n: want[n] for n in got}
    total = torch.stack([g.norm() for g in want.values()]).norm().item()
    worst = {}
    for n, g in got.items():
        rtol = 1e-2 if param_group(n) == "backbone" else 1e-3
        bound = rtol * want[n].norm().item() + 1e-7 * total
        worst[n] = (g - want[n]).norm().item() / bound
    return max(worst.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("name", ["burnin", "self_training"])
def test_ddp_step_equals_datr_tpu_global_step(run, name):
    """Each rank's metrics are the global batch's: every loss and
    grad_norm of datr_tpu's step at rtol 1e-4 / atol 1e-5 (the rank-mean
    logging counts excepted), num_pseudo summed over the ranks equal; the
    gradients the optimizer was given within the step tests' bounds; the
    ranks' metrics equal each other."""
    want = run["jax"][name]
    r0, r1 = (r[name] for r in run["ddp"])
    assert r0["metrics"] == r1["metrics"]
    assert set(r0["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        if k.startswith(RANK_MEANS):
            continue
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    if name == "self_training":
        assert 0 < r0["metrics"]["num_pseudo"] == int(
            want["metrics"]["num_pseudo"])
    worst = _grad_errors(r0["grads"], want["grads"])
    assert worst[1] <= 1.0, worst


@pytest.mark.parametrize("name", ["burnin", "self_training"])
def test_ddp_ranks_stay_bitwise_equal(run, name):
    """After the step every parameter, EMA track, global_proto and amount
    is bitwise equal on both ranks, and the prototype state is datr_tpu's
    (global_proto atol 1e-4, amount exact)."""
    a0, a1 = (r[name]["after"] for r in run["ddp"])
    for part in ("model", *EMA_TRACKS):
        for k, v in a0[part].items():
            assert torch.equal(v, a1[part][k]), (part, k)
    assert torch.equal(a0["global_proto"], a1["global_proto"])
    assert torch.equal(a0["amount"], a1["amount"])
    js = run["jax"][name]["state"]
    np.testing.assert_allclose(a0["global_proto"].numpy(), js.global_proto,
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(a0["amount"].numpy(), js.amount)
    assert a0["amount"].sum() > 0


def test_fsdp_step_equals_ddp_step(run):
    """The FSDP burn-in step against the DDP one: metrics rtol 1e-5, each
    gradient within 1e-4 of its norm (+ 1e-7 of the whole gradient's), the
    parameters after AdamW within 2 lr (Adam's first step maps a near-zero
    gradient of either sign to +-lr) and the EMA tracks and prototype
    state within f32 rounding; the ranks' gathered states equal."""
    d, f = run["ddp"][0]["burnin"], run["fsdp"][0]["burnin"]
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
    f1 = run["fsdp"][1]["burnin"]["after"]
    for part in ("model", *EMA_TRACKS):
        for k, v in f["after"][part].items():
            assert torch.equal(v, f1[part][k]), (part, k)


def test_fsdp_ranks_hold_half_of_each_large_leaf(run):
    """Under FSDP each rank holds its dim-0 shard of every parameter: about
    half of each leaf of 2^14 elements or more (at most one row more), and
    together the whole; the moments and the EMA tracks likewise."""
    b0, b1 = (r["burnin"]["bytes"] for r in run["fsdp"])
    for n, (local, whole) in b0["leaves"].items():
        assert local + b1["leaves"][n][0] == whole, n
        if whole >= 2 ** 14:
            row = whole // run["ddp"][0]["burnin"]["after"]["model"][
                n].shape[0]
            assert abs(local - whole / 2) <= row, (n, local, whole)
    for k in ("model", "ema_teacher", "moments"):
        assert 0.45 < b0[k] / (b0[k] + b1[k]) < 0.55, (k, b0[k], b1[k])
