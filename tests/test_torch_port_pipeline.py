"""The port's GPipe pipeline (datr_torch/parallel/pipeline.py) against
datr_tpu's on the CPU: four gloo ranks (tests/torch_port_dist_worker.py,
spawned; no rank imports JAX) on meshes ('data', 'pipe').

- `gpipe` of datr_tpu's toy stage (tests/test_pipeline.py:24-125) at
  (stages, n_micro) in {(2, 2), (4, 2), (2, 4)}, and composed with data
  parallelism (2 x 2), against datr_tpu's `gpipe` on its 8 virtual CPU
  devices: the output and the gradients of sum(out^2) for the stacked
  layers and the input.
- `make_pp_encoder_fn` in the model's eval forward: outputs against
  datr_tpu's sequential model (its own pipeline is held to that,
  test_pipeline.py), every parameter's gradient of sum(pred_logits^2)
  against the port's sequential encoder.
- `train_step_burnin` with `pp_n_micro=2` and `pp_dp_axis='data'` (2
  stages x 2 data ranks, DDP over 'data'): its metrics against datr_tpu's
  burn-in step on the whole batch, its gradients against the same ranks'
  step with the sequential encoder.
- `stack_layer_params` and the refusal of active dropout.

The model is tests/test_torch_port_selftrain.py's tiny one with 2 encoder
layers, a ResNet of one block per stage, datr_tpu's parameters drawn with
numpy over `jax.eval_shape`'s tree; its JAX functions are jitted at XLA's
lowest optimization level while the ranks run."""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)
from jax.sharding import Mesh

from datr_torch.convert import state_dict_from_flax
from datr_torch.models import cdn as tcdn
from datr_torch.models import dino as tdino
from datr_torch.parallel.pipeline import PP_DROPOUT_MESSAGE, stack_layer_params
from datr_torch.train import criterion as tcrit
from datr_tpu.models import dino as jdino
from datr_tpu.parallel.pipeline import gpipe as jax_gpipe
from datr_tpu.train import criterion as jcrit
from datr_tpu.train.state import create_train_state as jax_train_state
from datr_tpu.train.steps import train_step_burnin as jax_burnin

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
    rand_boxes,
)

STAGES = (1, 1, 1, 1)
WORLD = 4
LR, LR_BACKBONE = 1e-4, 1e-5
PKW = dict(KW, enc_layers=2, dn_labelbook_size=K)
CCFG = dict(num_classes=K, dn_single_pad=2, dn_groups=2)
GPIPE_CASES = ((2, 2, False), (4, 2, False), (2, 4, False), (2, 2, True))
D, B_TOY, L_TOY = 8, 4, 4


def _batch(pairs=4):
    """`pairs` source + `pairs` target images at 64x96 with pad masks, 3
    source targets per image (the last of every other image padding)."""
    rng = np.random.default_rng(23)
    n = 2 * pairs
    images = rng.standard_normal((n, *CANVAS, 3)).astype(np.float32)
    pad = np.zeros((n, *CANVAS), bool)
    pad[:, 56:] = True
    pad[1::2, :, 48:] = True
    images[pad] = 0.0
    valid = np.ones((pairs, 3), bool)
    valid[1::2, 2] = False
    return dict(images=images, pad_mask=pad,
                boxes=rand_boxes(rng, (pairs, 3)),
                labels=rng.integers(0, K, (pairs, 3)).astype(np.int32),
                valid=valid)


def _toy():
    rng = np.random.default_rng(5)
    stacked = dict(w=(0.3 * rng.standard_normal((L_TOY, D, D))),
                   b=(0.1 * rng.standard_normal((L_TOY, D))))
    x = rng.standard_normal((B_TOY, D))
    aux = 0.05 * rng.standard_normal((B_TOY, D))
    return ({k: v.astype(np.float32) for k, v in stacked.items()},
            x.astype(np.float32), aux.astype(np.float32))


def _jax_toy_stage(p, shared, x, aux):
    return x + jnp.tanh(x @ p["w"] + p["b"]) + aux


def _jax_gpipe_cases():
    """datr_tpu's gpipe of the toy: output and grads of sum(out^2) for
    (w, b, x), per case (its dp case on a 2 x 2 ('data', 'pipe') mesh)."""
    stacked, x, aux = _toy()
    out = {}
    for stages, n_micro, dp in GPIPE_CASES:
        n_dp = 2 if dp else 1
        mesh = Mesh(np.asarray(jax.devices()[:stages * n_dp]).reshape(
            n_dp, stages), ("data", "pipe"))

        def run(p, xx):
            return jax_gpipe(_jax_toy_stage, p, (), xx, jnp.asarray(aux),
                             mesh=mesh, n_micro=n_micro,
                             dp_axis="data" if dp else None)

        with mesh:
            y = jax.jit(run)(stacked, x)
            gp, gx = jax.jit(jax.grad(lambda p, xx: jnp.sum(run(p, xx) ** 2),
                                      argnums=(0, 1)))(stacked, x)
        out[(stages, n_micro, dp)] = dict(
            out=np.asarray(y), grads=(np.asarray(gp["w"]),
                                      np.asarray(gp["b"]), np.asarray(gx)))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setitem(jdino.RESNET_STAGES, "resnet50", STAGES)
    mp.setitem(tdino.RESNET_STAGES, "resnet50", STAGES)
    try:
        yield _run(tmp_path_factory.mktemp("pipeline"))
    finally:
        mp.undo()


def _run(tmp):
    jm = jdino.DINO(**PKW, use_remat=False)
    params = {"params": backbone_params(train_tree_shapes(jm, CANVAS), 6)}
    tx = _stash_grads()
    js = jax_train_state(params, tx, K, HD, jax.random.PRNGKey(3))
    _, dn_rng = jax.random.split(js.rng)  # datr_tpu/train/steps.py:31-33
    groups, _ = tcdn.cdn_layout(KW["dn_number"], KW["dn_single_pad"])
    draws = _jax_cdn_draws(dn_rng, 4, groups, KW["dn_single_pad"], K)
    sd = state_dict_from_flax(params)
    nb = _batch()
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    stacked, x, aux = _toy()
    ctx = worker.spawn([
        ("gpipe_cases", dict(
            cases=GPIPE_CASES, x=torch.from_numpy(x),
            aux=torch.from_numpy(aux),
            stacked={k: torch.from_numpy(v) for k, v in stacked.items()})),
        ("pp_model", dict(stages=STAGES, kw=PKW, sd=sd, batch=tb,
                          ccfg=CCFG, wd=tcrit.build_weight_dict(dec_layers=2),
                          draws=draws, lr=LR, lr_backbone=LR_BACKBONE))],
        WORLD, tmp)
    try:  # datr_tpu's side while the ranks run
        batch = {k: jnp.asarray(v) for k, v in nb.items()}

        def step():
            fn = jax.jit(jax_burnin.__wrapped__, compiler_options=FAST_COMPILE,
                         static_argnames=("model", "tx", "ccfg", "ema_decay"))
            new, metrics = jax.device_get(fn(
                jax.tree.map(jnp.copy, js), batch, jm, tx,
                jcrit.CriterionCfg(**CCFG),
                jcrit.build_weight_dict(dec_layers=2)))
            return dict(metrics=metrics,
                        grads=state_dict_from_flax(new.opt_state))

        def forward():
            out = jax.jit(lambda p: jm.apply(
                p, batch["images"], batch["pad_mask"], train=False),
                compiler_options=FAST_COMPILE)(params)
            return dict(out={k: np.asarray(out[k]) for k in
                             ("pred_logits", "pred_boxes")})

        with ThreadPoolExecutor(2) as pool:
            f_step, f_fwd = pool.submit(step), pool.submit(forward)
            toys = _jax_gpipe_cases()
            jax_step, jax_fwd = f_step.result(), f_fwd.result()
    finally:
        worker.join(ctx)
    return dict(toys=toys, jax_step=jax_step, jax_fwd=jax_fwd,
                gpipe=worker.results(tmp, "gpipe_cases", WORLD),
                model=worker.results(tmp, "pp_model", WORLD))


@pytest.mark.parametrize("case", GPIPE_CASES,
                         ids=lambda c: f"s{c[0]}_m{c[1]}{'_dp' if c[2] else ''}")
def test_gpipe_matches_datr_tpu(run, case):
    """Every rank's output rows and the gradients of sum(out^2) for the
    stacked layers (summed over the data ranks) and for its input rows
    equal datr_tpu's gpipe at rtol 1e-5 / atol 1e-5 (grads rtol 1e-4, as
    tests/test_pipeline.py holds its own)."""
    want = run["toys"][case]
    for r in run["gpipe"]:
        got = r[case]
        lo, hi = got["rows"]
        np.testing.assert_allclose(got["out"].numpy(), want["out"][lo:hi],
                                   rtol=1e-5, atol=1e-5)
        gw, gb, gx = want["grads"]
        for g, w in zip(got["grads"], (gw, gb, gx[lo:hi])):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5)


def test_pp_encoder_forward_and_grads_match_sequential(run):
    """The eval forward through the pipelined encoder against datr_tpu's
    sequential model (pred_boxes 1e-5, pred_logits 1e-4) on every rank,
    and every parameter's gradient of sum(pred_logits^2) against the
    port's sequential encoder on the same rank (each tensor within 1e-5
    of its norm, the two-stage top-k equal; the sequential model's
    gradients are datr_tpu's, test_torch_port_train.py). The encoder
    layers' gradients are nonzero and equal on every rank (summed over
    'pipe')."""
    want = run["jax_fwd"]
    for r in run["model"]:
        np.testing.assert_allclose(r["forward"]["pred_boxes"].numpy(),
                                   want["out"]["pred_boxes"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["forward"]["pred_logits"].numpy(),
                                   want["out"]["pred_logits"], rtol=1e-4,
                                   atol=1e-4)
        assert torch.equal(r["forward"]["topk_idx"],
                           r["seq_fwd"]["topk_idx"])
        seq = r["seq_grads"]
        assert set(r["grads"]) == set(seq)
        total = torch.stack([g.norm() for g in seq.values()]).norm()
        for n, g in r["grads"].items():
            err = (g - seq[n]).norm()
            assert err <= 1e-5 * seq[n].norm() + 1e-8 * total, n
    r0 = run["model"][0]["grads"]
    enc = [n for n in r0 if n.startswith("enc_layer")]
    assert len(enc) == 2 * len([n for n in r0 if n.startswith("enc_layer0")])
    for n in enc:
        assert r0[n].abs().max() > 0, n
        for r in run["model"][1:]:
            assert torch.equal(r["grads"][n], r0[n]), n


def test_pp_train_step_matches_datr_tpu(run):
    """train_step_burnin with pp_n_micro=2 over 2 stages x 2 data ranks:
    every loss and grad_norm against datr_tpu's burn-in step on the whole
    batch at rtol 1e-4 / atol 1e-5 (the rank-mean logging counts
    excepted); each gradient against the same ranks' step with the
    sequential encoder within 1e-5 of its norm (+ 1e-8 of the whole
    gradient's), and the state after the step bitwise equal on every
    rank. The sequential step's gradients are datr_tpu's in
    tests/test_torch_port_dist.py; on this batch of 8 images a change of
    intra-op threads alone (2 ranks against 4) moves the upstream
    gradients by 3e-3 of their norm (a near-tie in a discrete choice), so
    the pipeline is held where the threads and shards are the same."""
    from test_torch_port_dist import RANK_MEANS

    want = run["jax_step"]
    r0 = run["model"][0]["steps"]
    pp, seq = r0["pipelined"], r0["sequential"]
    for k, v in want["metrics"].items():
        if k.startswith(RANK_MEANS):
            continue
        np.testing.assert_allclose(pp["metrics"][k], v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert set(pp["grads"]) == set(seq["grads"])
    total = torch.stack([g.norm() for g in seq["grads"].values()]).norm()
    for n, g in pp["grads"].items():
        err = (g - seq["grads"][n]).norm()
        assert err <= 1e-5 * seq["grads"][n].norm() + 1e-8 * total, n
    for r in run["model"][1:]:
        assert r["steps"]["pipelined"]["metrics"] == pp["metrics"]
        for k, v in r["steps"]["pipelined"]["after"]["model"].items():
            assert torch.equal(v, pp["after"]["model"][k]), k


def test_pp_encoder_refuses_active_dropout(run):
    """An active dropout raises datr_tpu's NotImplementedError."""
    for r in run["model"]:
        assert r["refused"] == PP_DROPOUT_MESSAGE.format(0.1)


def test_stack_layer_params_roundtrip():
    """Stacking puts layer i's tensor at [i]; the stack's gradient reaches
    each layer."""
    params = {"enc_layer0.w": torch.ones(3, 3, requires_grad=True),
              "enc_layer0.b": torch.zeros(3, requires_grad=True),
              "enc_layer1.w": torch.full((3, 3), 2.0, requires_grad=True),
              "enc_layer1.b": torch.ones(3, requires_grad=True),
              "other.w": torch.ones(1)}
    s = stack_layer_params(params, "enc_layer{}", 2)
    assert set(s) == {"w", "b"}
    assert s["w"].shape == (2, 3, 3) and s["b"].shape == (2, 3)
    assert float(s["w"][1, 0, 0]) == 2.0 and float(s["b"][1, 0]) == 1.0
    (s["w"][1].sum() + 3 * s["b"][0].sum()).backward()
    assert torch.equal(params["enc_layer1.w"].grad, torch.ones(3, 3))
    assert torch.equal(params["enc_layer0.b"].grad, torch.full((3,), 3.0))
    assert params["enc_layer0.w"].grad is None or not params[
        "enc_layer0.w"].grad.any()

