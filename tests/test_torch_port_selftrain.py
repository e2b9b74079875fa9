"""The port's self-training slice against datr_tpu on the CPU: class-aware
NMS, the postprocess flags, pseudo-labels, the EMA tracks and their
per-epoch update, the self-training outputs of the train forward, the
target-domain criterion, one train_step_self_training from a converted
TrainState, the strong view and the self-training epoch loop. Inputs come
from numpy seeds (or datr_tpu's own draws, fed to the port); each test
states its tolerance."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)
from PIL import Image

from datr_torch.convert import load_flax_train_state, state_dict_from_flax
from datr_torch.data import strong_aug as taug
from datr_torch.data import synthetic as tsynth
from datr_torch.engine import train_one_epoch_self_training
from datr_torch.engine import update_emas_per_epoch as t_update_emas
from datr_torch.models import cdn as tcdn
from datr_torch.models import postprocess as tpp
from datr_torch.models.dino import DINO as TorchDINO
from datr_torch.train import criterion as tcrit
from datr_torch.train import ema as tema
from datr_torch.train.optim import Optimizer, param_group
from datr_torch.train.pseudo import pseudo_labels_from_outputs
from datr_torch.train.state import EMA_TRACKS, create_train_state
from datr_torch.train.steps import (
    self_training_loss_and_grads,
    teacher_pseudo_labels,
    train_step_self_training,
)
from datr_tpu.data import strong_aug as jaug
from datr_tpu.engine import update_emas_per_epoch as j_update_emas
from datr_tpu.models import postprocess as jpp
from datr_tpu.models.dino import DINO as JaxDINO
from datr_tpu.train import criterion as jcrit
from datr_tpu.train import ema as jema
from datr_tpu.train import pseudo as jpseudo
from datr_tpu.train.state import create_train_state as jax_train_state
from datr_tpu.train.steps import (
    train_step_self_training as jax_train_step_self_training,
)

K, HD = 4, 32
KW = dict(num_classes=K, num_queries=12, hidden_dim=HD, nheads=4,
          enc_layers=1, dec_layers=2, dim_feedforward=64, dn_number=4,
          dn_single_pad=2)
CANVAS = (64, 96)


def t(x):
    return torch.from_numpy(np.array(x))


def rand_boxes(rng, shape, lo=0.1, hi=0.4):
    """cxcywh boxes inside the unit square."""
    c = rng.random((*shape, 2)) * 0.5 + 0.25
    wh = rng.random((*shape, 2)) * (hi - lo) + lo
    return np.concatenate([c, wh], -1).astype(np.float32)


def _jax_cdn_draws(rng_key, b, groups, sp, num_classes):
    """The four draws datr_tpu's build_cdn_queries makes from its key
    (datr_tpu/models/cdn.py:95-112)."""
    k_flip, k_cls, k_sign, k_part = jax.random.split(rng_key, 4)
    shape = (b, groups, 2, sp)
    return tcdn.CdnDraws(
        t(jax.random.uniform(k_flip, shape)),
        t(jax.random.randint(k_cls, shape, 0, num_classes)),
        t(jax.random.randint(k_sign, (*shape, 4), 0, 2)),
        t(jax.random.uniform(k_part, (*shape, 4))))


# ---------------- NMS and the postprocess flags ----------------


def _nms_case(case):
    """(boxes xyxy [2, M, 4], scores [2, M], labels [2, M], max_out)."""
    rng = np.random.default_rng(len(case))
    M = 16
    xy = rng.random((2, M, 2)) * 60
    wh = rng.random((2, M, 2)) * 30 + 5
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.random((2, M)).astype(np.float32)
    labels = rng.integers(0, 3, (2, M))
    # duplicates (IoU 1) and near-duplicates (IoU well above 0.7)
    boxes[:, 5] = boxes[:, 2]
    boxes[:, 7] = boxes[:, 3] + np.float32(0.5)
    labels[:, 5], labels[:, 7] = labels[:, 2], labels[:, 3]
    max_out = 8
    if case == "ties":  # equal scores: the lower index ranks first
        scores[:, 5] = scores[:, 2]
        scores[:, 9:13] = scores[:, 8:9]
        boxes[:, 9:13] = boxes[:, 8:9]
        labels[:, 9:13] = labels[:, 8:9]
    elif case == "classes":  # the same box in other classes survives
        boxes[:, 10:14] = boxes[:, 1:2]
        labels[:, 10:14] = (labels[:, 1:2] + np.arange(1, 5)) % 4
    elif case == "below":  # every candidate marked -1, as pseudo does
        scores[:] = -1.0
    elif case == "max_out":  # more room than survivors, and than M
        max_out = 40
    return boxes, scores, labels.astype(np.int32), max_out


@pytest.mark.parametrize("case", ["ties", "classes", "below", "max_out"])
def test_batched_nms_equal(case):
    """keep_idx and keep_valid equal datr_tpu's."""
    boxes, scores, labels, max_out = _nms_case(case)
    want = jpp.batched_nms(boxes, scores, labels, iou_threshold=0.7,
                           max_out=max_out)
    got = tpp.batched_nms(t(boxes), t(scores), t(labels), 0.7, max_out)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert got[0].dtype == torch.int32
    if case != "below":
        assert 0 < got[1].sum() < boxes.shape[1] * 2


@pytest.mark.parametrize("kw,num_select", [(dict(not_to_xyxy=True), 50),
                                            (dict(), 50), (dict(), 200)])
def test_postprocess_flags(kw, num_select):
    """Scores, labels, queries equal; boxes atol 1e-6 (xyxy and cxcywh;
    num_select above queries x classes takes them all)."""
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((2, 30, K)) * 3).astype(np.float32)
    boxes = rand_boxes(rng, (2, 30))
    sizes = np.array([[480, 640], [600, 800]], np.float32)
    want = jpp.postprocess(logits, boxes, sizes, num_select=num_select, **kw)
    got = tpp.postprocess(t(logits), t(boxes), t(sizes), num_select, **kw)
    for k in ("labels", "queries"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    for k in ("scores", "boxes"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-6 * (1 if k == "scores" else 800))


def test_postprocess_with_nms():
    """The eval NMS path: valid equal, scores / boxes atol 1e-6 (boxes
    relative to the image side), labels and queries equal."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 40, K)) * 3).astype(np.float32)
    boxes = rand_boxes(rng, (2, 40), lo=0.3, hi=0.6)
    sizes = np.array([[480, 640], [600, 800]], np.float32)
    want = jpp.postprocess_with_nms(logits, boxes, sizes, num_select=60,
                                    nms_iou_threshold=0.5, max_out=60)
    got = tpp.postprocess_with_nms(t(logits), t(boxes), t(sizes), 60, 0.5, 60)
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    assert 0 < want["valid"].sum() < want["valid"].size
    for k in ("labels", "queries"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               atol=1e-6)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"],
                               atol=1e-6 * 800)


# ---------------- pseudo-labels ----------------


def test_pseudo_labels_equal():
    """Labels, valid and img_has_pseudo equal, boxes atol 1e-6. Scores
    stay at least 0.05 from the thresholds; image 2 has none above them;
    duplicated boxes make NMS remove some candidates."""
    rng = np.random.default_rng(4)
    n = 20
    logits = rng.uniform(-6.0, -3.0, (3, n, K)).astype(np.float32)
    hot = rng.random((3, n, K)) < 0.25
    logits[hot] = rng.uniform(0.5, 3.0, hot.sum())
    logits[2] = -5.0 - rng.random((n, K))  # no pseudo-labels at all
    boxes = rand_boxes(rng, (3, n))
    boxes[:, 1::4] = boxes[:, 0::4]  # duplicates: NMS keeps one
    thr = np.array([0.3, 0.4, 0.3, 0.5], np.float32)
    want = jpseudo.pseudo_labels_from_outputs(
        logits, boxes, np.full((3, 2), 64.0), CANVAS, thr, num_select=50,
        max_pseudo=30)
    got = pseudo_labels_from_outputs(t(logits), t(boxes), CANVAS, t(thr),
                                     num_select=50, max_pseudo=30)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=1e-6)
    assert list(want[3]) == [True, True, False]
    hot_pairs = (1 / (1 + np.exp(-logits)) >= thr).sum((1, 2))
    assert 0 < want[2].sum(1)[0] < hot_pairs[0]  # NMS removed some


# ---------------- EMA ----------------


def test_ema_update_and_decays():
    """ema_update with a traced f32 decay and with a static Python one,
    ramped_decay and cosine_decay: rtol 1e-6."""
    rng = np.random.default_rng(5)
    e = rng.standard_normal((3, 7)).astype(np.float32)
    p = rng.standard_normal((3, 7)).astype(np.float32)
    for updates in (1, 7, 2500):
        np.testing.assert_allclose(
            tema.ramped_decay(0.9997, updates).numpy(),
            jema.ramped_decay(0.9997, jnp.float32(updates)), rtol=1e-6)
    for ep in (0, 3, 10):
        np.testing.assert_allclose(
            tema.cosine_decay(0.9, 0.9999, ep, 10).numpy(),
            jema.cosine_decay(0.9, 0.9999, ep, 10), rtol=1e-6)
    for decay, jdecay in ((tema.ramped_decay(0.9997, 3),
                           jema.ramped_decay(0.9997, jnp.float32(3))),
                          (0.9997, 0.9997)):
        em, pm = torch.nn.Linear(7, 3), torch.nn.Linear(7, 3)
        em.weight.data, pm.weight.data = t(e), t(p)
        em.bias.data, pm.bias.data = t(p[0, :3]), t(e[0, :3])
        tema.ema_update(em, pm, decay)
        want = jema.ema_update({"w": e, "b": p[0, :3]},
                               {"w": p, "b": e[0, :3]}, jdecay)
        np.testing.assert_allclose(em.weight.detach().numpy(), want["w"],
                                   rtol=1e-6)
        np.testing.assert_allclose(em.bias.detach().numpy(), want["b"],
                                   rtol=1e-6)


def _tiny_batch():
    """2 source + 2 target images at 64x96 with pad masks, a strong view
    that differs from the weak one on the target half, 3 source targets
    per image (one of them padding)."""
    rng = np.random.default_rng(11)
    images = rng.standard_normal((4, 64, 96, 3)).astype(np.float32)
    pad = np.zeros((4, 64, 96), bool)
    pad[:, 56:] = True
    pad[1, :, 48:] = True
    pad[3, :, 40:] = True
    images[pad] = 0.0
    strong = images.copy()
    strong[2:] = images[2:] * 1.3 + 0.2
    strong[pad] = 0.0
    valid = np.ones((2, 3), bool)
    valid[1, 2] = False
    return dict(images=images, images_strong=strong, pad_mask=pad,
                boxes=rand_boxes(rng, (2, 3)),
                labels=rng.integers(0, K, (2, 3)).astype(np.int32),
                valid=valid, real_sizes=np.array([[56, 96], [56, 40]]))


@pytest.fixture(scope="module")
def jax_init():
    """datr_tpu's tiny model and its init, with the last layers of both box
    heads moved off their zero init: at zero init every box is its query's
    proposal, so the student's boxes would equal the teacher's pseudo-boxes
    up to rounding and the L1 loss would sit on its kink."""
    jm = JaxDINO(**KW, dn_labelbook_size=K, use_remat=False)
    b = {k: jnp.asarray(v) for k, v in _tiny_batch().items()}
    params = jax.device_get(jax.jit(lambda key: jm.init(
        key, b["images"], b["pad_mask"],
        targets={k: b[k] for k in ("boxes", "labels", "valid")},
        dn_rng=jax.random.PRNGKey(2), train=True,
        global_proto=jnp.zeros((K, HD)), amount=jnp.zeros((K,))))(
            jax.random.PRNGKey(1)))
    rng = np.random.default_rng(12)
    for head in ("bbox_head", "enc_out_bbox_head"):
        last = params["params"][head]["layer2"]
        for k in ("kernel", "bias"):
            last[k] = (rng.standard_normal(last[k].shape) * 0.05).astype(
                np.float32)
    return jm, params


def _port_state(seed=0):
    tm = TorchDINO(**KW, dn_labelbook_size=K)
    tm.init_params(torch.Generator().manual_seed(seed))
    return create_train_state(tm, Optimizer(tm))


def test_update_emas_per_epoch_two_epochs(jax_init):
    """Two self-training epochs' EMA updates from a converted TrainState
    whose student, teacher and best track all differ: every parameter and
    buffer of both tracks (the frozen batch-norm statistics included)
    rtol 1e-6 (atol 1e-7, about one rounding of the unit-sized operands,
    where they cancel), and the update count."""
    _, params = jax_init
    rng = np.random.default_rng(6)

    def moved(tree, scale):
        return jax.tree.map(lambda x: x + scale * rng.standard_normal(
            x.shape).astype(np.float32), tree)

    js = jax_train_state(params, optax.sgd(0.0), K, HD,
                         jax.random.PRNGKey(0))
    js = js.replace(params=moved(params, 0.5),
                    ema_teacher=moved(params, 0.1),
                    best_ema=moved(params, 0.2))
    state = load_flax_train_state(_port_state(), js)
    cfg = dict(burn_epochs=36, epochs=46, ema_decay_teacher=0.9,
               ema_decay_best_model=0.5)
    js = jax.jit(lambda s: j_update_emas(j_update_emas(s, 36, cfg), 37,
                                         cfg))(js)
    for epoch in (36, 37):
        t_update_emas(state, epoch, cfg)
    assert state.ema_updates == int(js.ema_updates) == 2
    for name in ("ema_teacher", "best_ema"):
        want = state_dict_from_flax(getattr(js, name))
        got = getattr(state, name).state_dict()
        assert any(k.endswith("running_mean") for k in want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{name} {k}")


# ---------------- the self-training step ----------------


def _stash_grads():
    """An optax transformation that makes no update and keeps the step's
    gradients as its state, so datr_tpu's own step hands them back."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _threshold(scores):
    """A threshold in the widest gap between consecutive scores among the
    top ones of the teacher, so no keep decision hangs on f32 noise."""
    s = np.sort(np.asarray(scores).ravel())[::-1]
    gaps = s[2:16] - s[3:17]
    k = int(np.argmax(gaps)) + 3
    assert gaps.max() > 1e-5, gaps
    return float((s[k - 1] + s[k]) / 2)


@pytest.fixture(scope="module")
def step(jax_init):
    """datr_tpu's tiny self-training step on a fresh TrainState, run by
    its own train_step_self_training (with a transformation that returns
    the gradients), and its self-training forward; the port started from
    the converted state, fed the same CDN draws and thresholds."""
    jm, params = jax_init
    batch = {k: jnp.asarray(v) for k, v in _tiny_batch().items()}
    tx = _stash_grads()
    js = jax_train_state(params, tx, K, HD, jax.random.PRNGKey(3))
    ccfg = jcrit.CriterionCfg(num_classes=K, dn_single_pad=2, dn_groups=2)
    wd = jcrit.build_weight_dict(dec_layers=2)
    _, dn_rng = jax.random.split(js.rng)  # datr_tpu/train/steps.py:31-33

    out = jax.device_get(jax.jit(lambda p: jm.apply(
        p, batch["images_strong"], batch["pad_mask"],
        targets={k: batch[k] for k in ("boxes", "labels", "valid")},
        dn_rng=dn_rng, train=True, self_training=True,
        global_proto=js.global_proto, amount=js.amount))(params))
    # the port's states first: the step donates datr_tpu's
    port0 = load_flax_train_state(_port_state(), js)
    sstate = load_flax_train_state(_port_state(), js)
    tb = {k: t(v) for k, v in _tiny_batch().items()}
    with torch.no_grad():  # the teacher's scores, as datr_tpu's to ~1e-7
        teacher = port0.ema_teacher(tb["images"][2:], tb["pad_mask"][2:])
    thr = np.full((K,), _threshold(teacher["pred_logits"].sigmoid()),
                  np.float32)
    teacher0 = {k: v.clone()
                for k, v in sstate.ema_teacher.state_dict().items()}
    new_js, metrics = jax.device_get(jax_train_step_self_training(
        js, batch, jm, tx, ccfg, wd, jnp.asarray(thr),
        canvas_hw=CANVAS))

    groups, _ = tcdn.cdn_layout(KW["dn_number"], KW["dn_single_pad"])
    draws = _jax_cdn_draws(dn_rng, 2, groups, KW["dn_single_pad"], K)
    tccfg = tcrit.CriterionCfg(num_classes=K, dn_single_pad=2, dn_groups=2)
    twd = tcrit.build_weight_dict(dec_layers=2)
    pseudo = teacher_pseudo_labels(port0, tb, t(thr), CANVAS)
    total, src, tgt, p_out = self_training_loss_and_grads(
        port0, tb, tccfg, twd, pseudo, dn_draws=draws)
    grads = {n: p.grad.clone() for n, p in port0.model.named_parameters()
             if p.grad is not None}
    p_metrics = train_step_self_training(sstate, tb, tccfg, twd, t(thr),
                                         CANVAS, dn_draws=draws)
    return dict(thr=thr, jax=dict(out=out, grads=new_js.opt_state,
                                  metrics=metrics),
                port=dict(out=p_out, pseudo=pseudo, grads=grads,
                          metrics=p_metrics, total=total, state=sstate,
                          teacher0=teacher0, model=port0.model))


OUT_ATOL = {"logits": 2e-3, "boxes": 1e-4, "da_": 1e-4,
            "new_global_proto": 1e-4}


def _out_atol(key):
    for part, tol in OUT_ATOL.items():
        if part in key:
            return tol
    return 1e-4


def test_self_training_forward_outputs(step):
    """Every output of datr_tpu's self-training forward, the `*_target`
    ones included, at the burn-in test's tolerances (logits 2e-3, boxes and
    DA terms 1e-4)."""
    want, got = step["jax"]["out"], step["port"]["out"]
    assert {k for k in want if k.endswith("_target")
            and not k.startswith("da_")} == {
        f"{p}_{q}_target" for p in ("pred", "aux", "interm")
        for q in ("logits", "boxes")}
    assert set(got) == set(want) | {"topk_idx", "topk_idx_target"}
    for key, w in want.items():
        g = got[key].detach().numpy()
        assert g.shape == np.shape(w), key
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=_out_atol(key),
                                       err_msg=key)


def test_target_domain_criterion(step):
    """The target-domain criterion on datr_tpu's self-training outputs with
    pseudo-labels, one image without any (img_mask 0): the same keys (no DN,
    no DA), values rtol 1e-5 / atol 1e-6."""
    rng = np.random.default_rng(8)
    labels = rng.integers(0, K, (2, 5)).astype(np.int32)
    boxes = rand_boxes(rng, (2, 5))
    valid = np.zeros((2, 5), bool)
    valid[0, :3] = True
    mask = valid.any(1).astype(np.float32)
    ccfg = jcrit.CriterionCfg(num_classes=K, dn_single_pad=2, dn_groups=2)
    out = step["jax"]["out"]
    want = jax.device_get(jax.jit(lambda o: jcrit.criterion(
        o, labels, boxes, valid, ccfg, target_domain=True,
        img_mask=mask))(out))
    got = tcrit.criterion({k: t(v) for k, v in out.items()}, t(labels),
                          t(boxes), t(valid), tcrit.CriterionCfg(
                              num_classes=K, dn_single_pad=2, dn_groups=2),
                          target_domain=True, img_mask=t(mask))
    assert set(got) == set(want)
    assert not any("_dn" in k or k.endswith("_DA") for k in got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_self_training_step_losses(step):
    """The step's metrics: num_pseudo equal (and not every candidate's),
    every loss (source and `_target`) and the total rtol 1e-4 / atol 1e-5,
    grad_norm rtol 1e-4."""
    want, got = step["jax"]["metrics"], step["port"]["metrics"]
    assert set(got) == set(want)
    assert 0 < int(got["num_pseudo"]) == int(want["num_pseudo"]) < 2 * 48
    assert int(step["port"]["pseudo"][2].sum()) == int(want["num_pseudo"])
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(step["port"]["total"].item(), want["loss"],
                               rtol=1e-5)


def test_self_training_step_gradients(step):
    """Every trainable gradient by relative norm, |g - g_jax| <= rtol
    |g_jax| + atol: rtol 1e-3, the backbone 1e-2 (the burn-in step's
    tolerances and reasons, tests/test_torch_port_train.py). The atol, 1e-7
    of the whole gradient's norm, covers the gradients that are zero in
    exact arithmetic (a conv bias in front of a GroupNorm): their rounding
    noise grows with the losses, which self-training doubles."""
    want = state_dict_from_flax(step["jax"]["grads"])
    got = step["port"]["grads"]
    model = step["port"]["model"]
    assert set(got) == {n for n, p in model.named_parameters()
                        if p.requires_grad}
    atol = 1e-7 * torch.stack([want[n].norm() for n in got]).norm().item()
    for n, g in got.items():
        rtol = 1e-2 if param_group(n) == "backbone" else 1e-3
        err = (g - want[n]).norm().item()
        assert err <= rtol * want[n].norm().item() + atol, (n, err)


def test_self_training_step_leaves_the_teacher(step):
    """The step trains the student only: the EMA tracks keep their weights,
    the step count and the prototype state move."""
    state = step["port"]["state"]
    assert state.step == 1 and state.amount.sum().item() > 0
    for name in EMA_TRACKS:
        track = getattr(state, name)
        assert not track.training
        assert not any(p.requires_grad for p in track.parameters())
    for k, v in state.ema_teacher.state_dict().items():
        assert torch.equal(v, step["port"]["teacher0"][k]), k
    assert any(not torch.equal(p, step["port"]["teacher0"][n])
               for n, p in state.model.named_parameters())


# ---------------- data and the epoch loop ----------------


def test_strong_view_matches_datr_tpu():
    """The strong view of the synthetic batches is datr_tpu's
    strong_augment, pixel for pixel, and so are the numpy brightness and
    contrast copies of its single-domain extras."""
    img = np.random.default_rng(9).integers(0, 256, (30, 40, 3), np.uint8)
    for f in (0.6, 1.0, 1.37):
        np.testing.assert_array_equal(
            taug.adjust_brightness(img, f),
            np.asarray(jaug.adjust_brightness(Image.fromarray(img), f)))
        np.testing.assert_array_equal(
            taug.adjust_contrast(img, f),
            np.asarray(jaug.adjust_contrast(Image.fromarray(img), f)))
    for seed in (0, 1):
        np.testing.assert_array_equal(
            taug.strong_augment(img, random.Random(seed)),
            np.asarray(jaug.strong_augment(Image.fromarray(img),
                                           random.Random(seed))))


def test_synthetic_strong_batch():
    """strong=True: the source half of images_strong is the weak view, the
    target half differs from it inside the image and not on the pads;
    real_sizes is the target half's unpadded size."""
    src = tsynth.SyntheticDetectionDataset(2, (60, 90), 8, seed=1)
    tgt = tsynth.SyntheticDetectionDataset(2, (50, 80), 8, seed=2, fog=0.35)
    b = tsynth.synthetic_da_batch(src, tgt, [0, 1], CANVAS, max_boxes=5,
                                  device="cpu", strong=True)
    weak = tsynth.synthetic_da_batch(src, tgt, [0, 1], CANVAS, max_boxes=5,
                                     device="cpu")
    assert set(b) == set(weak) | {"images_strong", "real_sizes"}
    for k in weak:
        assert torch.equal(b[k], weak[k]), k
    torch.testing.assert_close(b["images_strong"][:2], b["images"][:2],
                               rtol=0, atol=0)
    assert b["real_sizes"].tolist() == [[50, 80], [50, 80]]
    inside = ~b["pad_mask"][2:]
    assert (b["images_strong"][2:] != b["images"][2:])[inside].any()
    assert (b["images_strong"][2:][~inside] == 0).all()


def test_train_one_epoch_self_training():
    """engine.train_one_epoch_self_training over synthetic strong batches
    with a threshold below the seeded teacher's scores: finite metrics,
    pseudo-labels on every step, the source and `_target` loss keys, and
    the per-step model_ema lerp."""
    src = tsynth.SyntheticDetectionDataset(4, (60, 90), K - 1, seed=0)
    tgt = tsynth.SyntheticDetectionDataset(4, (60, 90), K - 1, seed=1,
                                           fog=0.35)
    batches = [tsynth.synthetic_da_batch(src, tgt, [2 * i, 2 * i + 1],
                                         CANVAS, max_boxes=6, device="cpu",
                                         strong=True) for i in range(2)]
    state = _port_state()
    ema0 = {k: v.clone() for k, v in state.model_ema.state_dict().items()}
    ccfg = tcrit.CriterionCfg(num_classes=K, dn_single_pad=2, dn_groups=2)
    wd = tcrit.build_weight_dict(dec_layers=2)
    metrics = train_one_epoch_self_training(
        state, batches, ccfg, wd, np.full((K,), 1e-3, np.float32), CANVAS,
        ema_decay=0.5)
    assert all(np.isfinite(v) for v in metrics.values())
    assert metrics["num_pseudo"] > 0
    weighted = {k for k in metrics if k.startswith("loss_")
                and not k.startswith(("loss_xy", "loss_hw"))}
    assert weighted == set(wd) | {
        f"{k}_target" for k in wd if "_dn" not in k and "_DA" not in k}
    assert state.step == 2
    w = "class_head.weight"
    assert not torch.equal(state.model_ema.state_dict()[w], ema0[w])
    torch.testing.assert_close(state.ema_teacher.state_dict()[w], ema0[w],
                               rtol=0, atol=0)
