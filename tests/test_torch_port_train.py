"""The port's burn-in training slice against datr_tpu on the CPU: building
blocks (focal/CE, boxes, matching, CDN, DA parts), the criterion, the train
forward, one train_step_burnin, the parameter groups and the synthetic data.
Inputs come from numpy seeds (or datr_tpu's own draws, fed to the port);
each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from datr_torch.convert import load_flax_params, state_dict_from_flax
from datr_torch.data import synthetic as tsynth
from datr_torch.models import cdn as tcdn
from datr_torch.models import da as tda
from datr_torch.models.dino import DINO as TorchDINO
from datr_torch.ops import focal as tfocal
from datr_torch.ops import matcher as tmatcher
from datr_torch.train import criterion as tcrit
from datr_torch.train.optim import Optimizer, param_group
from datr_torch.train.state import create_train_state
from datr_torch.train.steps import loss_and_grads, train_step_burnin
from datr_torch.utils import boxes as tboxes
from datr_tpu.data import synthetic as jsynth
from datr_tpu.data.transforms import finalize_example
from datr_tpu.models import cdn as jcdn
from datr_tpu.models import da as jda
from datr_tpu.models.dino import DINO as JaxDINO
from datr_tpu.ops import focal as jfocal
from datr_tpu.ops import matcher as jmatcher
from datr_tpu.train import criterion as jcrit
from datr_tpu.train.optim import make_optimizer, param_labels
from datr_tpu.train.state import create_train_state as jax_train_state
from datr_tpu.train.steps import train_step_burnin as jax_train_step_burnin
from datr_tpu.utils import boxes as jboxes

K, HD = 4, 32
KW = dict(num_classes=K, num_queries=12, hidden_dim=HD, nheads=4,
          enc_layers=1, dec_layers=2, dim_feedforward=64, dn_number=4,
          dn_single_pad=2)
LR, LR_BACKBONE = 1e-4, 1e-5


def t(x):
    return torch.from_numpy(np.array(x))


def rand_boxes(rng, shape, lo=0.1, hi=0.4):
    """cxcywh boxes inside the unit square."""
    c = rng.random((*shape, 2)) * 0.5 + 0.25
    wh = rng.random((*shape, 2)) * (hi - lo) + lo
    return np.concatenate([c, wh], -1).astype(np.float32)


# ---------------- building blocks ----------------


def test_focal_and_sigmoid_ce():
    """Elementwise, atol 1e-6."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 5)) * 4).astype(np.float32)
    targets = (rng.random((3, 7, 5)) < 0.3).astype(np.float32)
    np.testing.assert_allclose(
        tfocal.sigmoid_focal_loss(t(logits), t(targets), 0.25).numpy(),
        jfocal.sigmoid_focal_loss(logits, targets, 0.25), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tfocal.sigmoid_ce(t(logits), t(targets)).numpy(),
        jfocal.optax_sigmoid_ce(logits, targets), rtol=0, atol=1e-6)


def test_box_iou_and_giou():
    """Pairwise and elementwise IoU/GIoU on random and degenerate xyxy
    boxes, atol 1e-6."""
    rng = np.random.default_rng(1)
    b1 = jboxes.box_cxcywh_to_xyxy(rand_boxes(rng, (6,)))
    b2 = jboxes.box_cxcywh_to_xyxy(rand_boxes(rng, (6,)))
    b1 = np.asarray(b1).copy()
    b1[0, 2:] = b1[0, :2]  # zero area
    b1[1] = b2[1]  # identical
    b2 = np.asarray(b2)
    for fn in ("box_area",):
        np.testing.assert_allclose(getattr(tboxes, fn)(t(b1)).numpy(),
                                   getattr(jboxes, fn)(b1), atol=1e-6)
    for fn in ("box_iou", "box_iou_elementwise"):
        for a, b in zip(getattr(tboxes, fn)(t(b1), t(b2)),
                        getattr(jboxes, fn)(b1, b2)):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
    for fn in ("generalized_box_iou", "generalized_box_iou_elementwise"):
        np.testing.assert_allclose(getattr(tboxes, fn)(t(b1), t(b2)).numpy(),
                                   getattr(jboxes, fn)(b1, b2), rtol=0,
                                   atol=1e-6)


def _matching_inputs(seed, b=3, n=30, tt=6):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, n, K)) * 2).astype(np.float32)
    boxes = rand_boxes(rng, (b, n))
    labels = rng.integers(0, K, (b, tt)).astype(np.int32)
    gt = rand_boxes(rng, (b, tt))
    valid = np.ones((b, tt), bool)
    valid[0, 4:] = False  # padded targets
    valid[1, ::2] = False
    valid[2, :] = False  # an image without targets
    return logits, boxes, labels, gt, valid


def test_matching_cost():
    """[T, N] cost with zeroed invalid rows, atol 1e-5."""
    logits, boxes, labels, gt, valid = _matching_inputs(2)
    want = jax.vmap(jmatcher.detr_matching_cost)(logits, boxes, labels, gt,
                                                 valid)
    got = tmatcher.detr_matching_cost(t(logits), t(boxes), t(labels), t(gt),
                                      t(valid))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_scipy_assignments_equal_jax_hungarian(seed):
    """scipy's linear_sum_assignment over the valid rows assigns every valid
    target the prediction datr_tpu's in-graph hungarian assigns it, with
    padded target rows in the cost."""
    logits, boxes, labels, gt, valid = _matching_inputs(seed)
    want = np.asarray(jmatcher.batch_match(logits, boxes, labels, gt, valid))
    got = tmatcher.batch_match(t(logits), t(boxes), t(labels), t(gt),
                               t(valid)).numpy()
    assert valid.any(1).sum() == 2
    np.testing.assert_array_equal(np.where(valid, got, -1),
                                  np.where(valid, want, -1))
    minsum = tmatcher.minsum_match(tmatcher.detr_matching_cost(
        t(logits), t(boxes), t(labels), t(gt), t(valid))).numpy()
    np.testing.assert_array_equal(minsum, jax.vmap(
        lambda *a: jmatcher.minsum_match(jmatcher.detr_matching_cost(*a)))(
            logits, boxes, labels, gt, valid))


def _jax_cdn_draws(rng_key, b, groups, sp, num_classes):
    """The four draws datr_tpu's build_cdn_queries makes from its key
    (datr_tpu/models/cdn.py:95-112), in one jit (eagerly they take seconds
    of small compiles)."""
    shape = (b, groups, 2, sp)

    def draw(key):
        k_flip, k_cls, k_sign, k_part = jax.random.split(key, 4)
        return (jax.random.uniform(k_flip, shape),
                jax.random.randint(k_cls, shape, 0, num_classes),
                jax.random.randint(k_sign, (*shape, 4), 0, 2),
                jax.random.uniform(k_part, (*shape, 4)))

    return tcdn.CdnDraws(*map(t, jax.jit(draw)(rng_key)))


@pytest.mark.parametrize("nmax", [3, 7])
def test_cdn_queries_with_jax_draws(nmax):
    """Fed datr_tpu's draws, the port builds the same DN queries: labels
    and validity exactly, embeddings and boxes to atol 1e-6. The mask is
    datr_tpu's."""
    rng = np.random.default_rng(nmax)
    b, sp, dn_number = 2, 5, 10
    gt = rand_boxes(rng, (b, nmax))
    labels = rng.integers(0, K, (b, nmax)).astype(np.int32)
    valid = np.ones((b, nmax), bool)
    valid[1, 2:] = False
    table = rng.standard_normal((K + 1, HD)).astype(np.float32)
    key = jax.random.PRNGKey(nmax)
    want = jcdn.build_cdn_queries(key, gt, labels, valid, table, K,
                                  dn_number, sp, 0.5, 0.4)
    groups, pad = tcdn.cdn_layout(dn_number, sp)
    got = tcdn.build_cdn_queries(
        _jax_cdn_draws(key, b, groups, sp, K), t(gt), t(labels), t(valid),
        t(table), dn_number, sp, 0.5, 0.4)
    np.testing.assert_array_equal(got.noised_labels.numpy(),
                                  want.noised_labels)
    np.testing.assert_array_equal(got.dn_valid.numpy(), want.dn_valid)
    np.testing.assert_allclose(got.query_label_embed.numpy(),
                               want.query_label_embed, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.query_bbox_unsig.numpy(),
                               want.query_bbox_unsig, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        tcdn.cdn_self_attn_mask(9, sp, groups).numpy(),
        jcdn.cdn_self_attn_mask(9, sp, groups))


def test_grad_reverse_negates_the_gradient():
    x = torch.randn(3, 4, requires_grad=True)
    w = torch.randn(3, 4)
    y = tda.grad_reverse(x)
    torch.testing.assert_close(y, x, rtol=0, atol=0)
    (y * w).sum().backward()
    torch.testing.assert_close(x.grad, -w, rtol=0, atol=0)


def test_image_discriminator():
    """NHWC in datr_tpu, NCHW in the port; atol 1e-5."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 7, HD)).astype(np.float32)
    jm = jda.ImageDiscriminator()
    params = jm.init(jax.random.PRNGKey(0), x)
    want = jm.apply(params, x)
    tm = tda.ImageDiscriminator(HD)
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = tm(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_class_prototypes_with_empty_classes():
    """Classes no query predicts keep their global prototype and count;
    atol 1e-6."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 6, HD)).astype(np.float32)
    logits = rng.standard_normal((2, 6, K)).astype(np.float32)
    logits[..., 3] = -9.0  # class 3 never wins
    gp = rng.standard_normal((K, HD)).astype(np.float32)
    amount = np.array([0.0, 4.0, 2.0, 5.0], np.float32)
    want = jda.class_prototypes(q, logits, gp, amount)
    got = tda.class_prototypes(t(q), t(logits), t(gp), t(amount))
    assert want.valid_class_map[3] == 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)


# ---------------- the tiny model: forward, criterion, one step --------------


def _tiny_batch():
    """4 images at 64x96 (2 source + 2 target), padded rows and columns,
    3 source targets per image, one of them padding. (At 64x64 the last
    level is 1x1 and its GroupNorm's gradient is exactly zero in datr_tpu
    but rounding noise in PyTorch.)"""
    rng = np.random.default_rng(11)
    images = rng.standard_normal((4, 64, 96, 3)).astype(np.float32)
    pad = np.zeros((4, 64, 96), bool)
    pad[:, 56:] = True
    pad[1, :, 48:] = True
    pad[3, :, 40:] = True
    images[pad] = 0.0
    valid = np.ones((2, 3), bool)
    valid[1, 2] = False
    return dict(images=images, pad_mask=pad, boxes=rand_boxes(rng, (2, 3)),
                labels=rng.integers(0, K, (2, 3)).astype(np.int32),
                valid=valid)


@pytest.fixture(scope="module")
def step():
    """datr_tpu's tiny burn-in setup (tests/test_train_step.py:20-54, inputs
    made by numpy): its init, its loss/grad (with the forward outputs and
    the two-stage selections) and its train_step_burnin; the port loaded
    with the same weights and fed the same CDN draws."""
    jm = JaxDINO(**KW, dn_labelbook_size=K, use_remat=False)
    batch = {k: jnp.asarray(v) for k, v in _tiny_batch().items()}
    targets = {k: batch[k] for k in ("boxes", "labels", "valid")}
    gp, am = jnp.zeros((K, HD)), jnp.zeros((K,))
    params = jax.jit(lambda key: jm.init(
        key, batch["images"], batch["pad_mask"], targets=targets,
        dn_rng=jax.random.PRNGKey(2), train=True, global_proto=gp,
        amount=am))(jax.random.PRNGKey(1))
    tx = make_optimizer(params, lr=LR, lr_backbone=LR_BACKBONE)
    state = jax_train_state(params, tx, K, HD, jax.random.PRNGKey(3))
    ccfg = jcrit.CriterionCfg(num_classes=K, dn_single_pad=2, dn_groups=2)
    wd = jcrit.build_weight_dict(dec_layers=2)
    _, dn_rng = jax.random.split(state.rng)  # datr_tpu/train/steps.py:31-33

    seen = []
    top_k = jax.lax.top_k

    def spy(x, k):  # the source pass's, then the target pass's selection
        v, i = top_k(x, k)
        seen.append(i)
        return v, i

    def loss_fn(p):  # datr_tpu/train/steps.py:54-76
        out = jm.apply(p, batch["images"], batch["pad_mask"],
                       targets=targets, dn_rng=dn_rng, train=True,
                       global_proto=gp, amount=am)
        losses = jcrit.criterion(out, batch["labels"], batch["boxes"],
                                 batch["valid"], ccfg)
        return jcrit.weighted_total(losses, wd), (losses, out, seen[:2])

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.lax, "top_k", spy)
    try:
        (total, (losses, out, topk)), grads = jax.device_get(jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params))
    finally:
        mp.undo()
    new_state, metrics = jax.device_get(jax_train_step_burnin(
        jax.tree.map(jnp.copy, state), batch, jm, tx, ccfg, wd))

    groups, _ = tcdn.cdn_layout(KW["dn_number"], KW["dn_single_pad"])
    draws = _jax_cdn_draws(dn_rng, 2, groups, KW["dn_single_pad"], K)
    tbatch = {k: t(v) for k, v in _tiny_batch().items()}
    tccfg = tcrit.CriterionCfg(num_classes=K, dn_single_pad=2, dn_groups=2)
    twd = tcrit.build_weight_dict(dec_layers=2)

    def port_state():
        tm = TorchDINO(**KW, dn_labelbook_size=K)
        assert load_flax_params(tm, params) == []
        return create_train_state(tm, Optimizer(tm, lr=LR,
                                                lr_backbone=LR_BACKBONE))

    pstate = port_state()
    p_total, p_losses, p_out = loss_and_grads(pstate, tbatch, tccfg, twd,
                                              dn_draws=draws)
    p_grads = {n: p.grad.clone() for n, p in
               pstate.model.named_parameters() if p.grad is not None}
    sstate = port_state()
    p_metrics = train_step_burnin(sstate, tbatch, tccfg, twd, dn_draws=draws)
    return dict(
        params=params, jax=dict(total=total, losses=losses, out=out,
                                topk=topk, grads=grads, state=new_state,
                                metrics=metrics),
        port=dict(total=p_total, losses=p_losses, out=p_out, grads=p_grads,
                  state=sstate, metrics=p_metrics))


# forward tolerances: datr_tpu's own against the reference (logits 2e-3,
# boxes 1e-4, tests/test_torch_parity.py:82-109); the DA terms are means
# and prototypes of those features (1e-4)
OUT_ATOL = {"logits": 2e-3, "boxes": 1e-4, "da_backbone": 1e-4,
            "da_protos": 1e-4, "da_query": 1e-4, "new_global_proto": 1e-4}


def _out_atol(key):
    for part, tol in OUT_ATOL.items():
        if part in key:
            return tol
    return 1e-4


def test_train_forward_every_output(step):
    """The train forward's outputs: every key datr_tpu returns, with the
    same two-stage selections."""
    want, got = step["jax"]["out"], step["port"]["out"]
    np.testing.assert_array_equal(got["topk_idx"].numpy(),
                                  step["jax"]["topk"][0])
    np.testing.assert_array_equal(got["topk_idx_target"].numpy(),
                                  step["jax"]["topk"][1])
    assert set(got) == set(want) | {"topk_idx", "topk_idx_target"}
    for key, w in want.items():
        g = got[key].detach().numpy()
        assert g.shape == np.shape(w), key
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=_out_atol(key),
                                       err_msg=key)


@pytest.mark.parametrize("matcher", ["HungarianMatcher",
                                     "SimpleMinsumMatcher"])
def test_criterion_loss_dict(step, matcher):
    """The port's criterion on datr_tpu's forward outputs gives datr_tpu's
    loss dict: the same keys, values to rtol 1e-5 / atol 1e-6."""
    b = _tiny_batch()
    kw = dict(num_classes=K, dn_single_pad=2, dn_groups=2,
              matcher_type=matcher)
    want = step["jax"]["losses"]
    if matcher != "HungarianMatcher":
        want = jax.device_get(jcrit.criterion(
            jax.tree.map(jnp.asarray, step["jax"]["out"]), b["labels"],
            b["boxes"], b["valid"], jcrit.CriterionCfg(**kw)))
    out = {k: t(v) for k, v in step["jax"]["out"].items()}
    got = tcrit.criterion(out, t(b["labels"]), t(b["boxes"]), t(b["valid"]),
                          tcrit.CriterionCfg(**kw))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kw", [dict(), dict(dec_layers=6, use_dn=False),
                                dict(no_interm_box_loss=True,
                                     da_proto_loss_coef=0.5)])
def test_build_weight_dict(kw):
    assert tcrit.build_weight_dict(**kw) == jcrit.build_weight_dict(**kw)


def test_train_step_losses(step):
    """Every loss of the step and its total, rtol 1e-4 / atol 1e-5 (f32
    features of two frameworks through the whole model)."""
    want, got = step["jax"]["losses"], step["port"]["losses"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(step["port"]["total"].item(),
                               step["jax"]["total"], rtol=1e-5)
    m, jm = step["port"]["metrics"], step["jax"]["metrics"]
    assert set(m) == set(jm)
    np.testing.assert_allclose(m["grad_norm"].item(), jm["grad_norm"],
                               rtol=1e-4)


def test_train_step_gradients(step):
    """Every trainable gradient by relative norm, |g - g_jax| <= rtol
    |g_jax| + 1e-6, and none for the frozen group. rtol 1e-3 for the main
    group (measured <= 6e-6). 1e-2 for the backbone (measured <= 4e-3):
    at this size its gradient arrives through GroupNorms whose one-channel
    groups span 2 to 96 pixels, which cancel all but a small part of the
    incoming gradient and so magnify f32 rounding. The atol covers the
    gradients that are zero in exact arithmetic (a conv bias in front of
    such a GroupNorm; level_embed behind zero-init sampling projections)."""
    want = state_dict_from_flax(step["jax"]["grads"])
    got = step["port"]["grads"]
    model = step["port"]["state"].model
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert set(got) == trainable
    for n, g in got.items():
        rtol = 1e-2 if param_group(n) == "backbone" else 1e-3
        err = (g - want[n]).norm().item()
        assert err <= rtol * want[n].norm().item() + 1e-6, (n, err)


def test_train_step_update_and_prototypes(step):
    """After one AdamW step every parameter is within 2 lr of datr_tpu's
    (Adam's first step maps a near-zero gradient of either sign to +-lr),
    the frozen group is untouched, and the prototype state matches."""
    new = state_dict_from_flax(step["jax"]["state"].params)
    old = state_dict_from_flax(step["params"])
    state = step["port"]["state"]
    for n, p in state.model.state_dict().items():
        group = param_group(n)
        if group == "frozen":
            torch.testing.assert_close(p, old[n], rtol=0, atol=0)
            continue
        lr = LR if group == "main" else LR_BACKBONE
        err = (p - new[n]).abs().max().item()
        assert err <= 2 * lr + 1e-6, (n, err)
    js = step["jax"]["state"]
    np.testing.assert_allclose(state.global_proto.numpy(), js.global_proto,
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(state.amount.numpy(), js.amount)
    assert state.step == 1


def test_param_groups_match_param_labels(step):
    """The port's frozen / backbone / main membership equals datr_tpu's
    param_labels, entry by entry of the converted state dict."""
    code = {"main": 0, "backbone": 1, "frozen": 2}
    labels = param_labels(step["params"])
    coded = unflatten_dict({
        k: np.full(np.shape(v), code[lab], np.float32) for k, lab, v in zip(
            flatten_dict(labels).keys(), flatten_dict(labels).values(),
            flatten_dict(step["params"]).values())})
    want = state_dict_from_flax(coded)
    model = step["port"]["state"].model
    assert set(want) == set(model.state_dict())
    for n, v in want.items():
        assert (v == code[param_group(n)]).all(), n
    for n, p in model.named_parameters():
        assert p.requires_grad == (param_group(n) != "frozen"), n


# ---------------- synthetic data ----------------


@pytest.mark.parametrize("fog", [0.0, 0.35])
def test_synthetic_dataset_pixel_equal(fog):
    kw = dict(n_images=3, hw=(60, 90), num_classes=8, max_objects=6, seed=4,
              fog=fog)
    jd, td = jsynth.SyntheticDetectionDataset(**kw), \
        tsynth.SyntheticDetectionDataset(**kw)
    for i in range(3):
        (jimg, jt), (timg, tt) = jd.load(i), td.load(i)
        np.testing.assert_array_equal(timg, np.asarray(jimg))
        for k in ("boxes", "labels", "orig_size", "size"):
            np.testing.assert_array_equal(tt[k], jt[k])


def test_synthetic_da_batch_matches_finalize_example():
    """The batch on the canvas equals datr_tpu's finalize_example of the
    same images (normalized pixels atol 1e-6)."""
    src = tsynth.SyntheticDetectionDataset(4, (60, 90), 8, seed=1)
    tgt = tsynth.SyntheticDetectionDataset(4, (50, 80), 8, seed=2, fog=0.35)
    canvas = (64, 96)
    got = tsynth.synthetic_da_batch(src, tgt, [1, 3], canvas, max_boxes=5,
                                    device="cpu")
    want = {k: [] for k in got}
    for ds, idx in ((src, [1, 3]), (tgt, [1, 3])):
        for i in idx:
            img, tg = ds.load(i)
            f = finalize_example(img, tg, canvas, 5)
            want["images"].append(f["image"])
            want["pad_mask"].append(f["pad_mask"])
            if ds is src:
                for k in ("boxes", "labels", "valid"):
                    want[k].append(f[k])
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.stack(v), rtol=0,
                                   atol=1e-6, err_msg=k)


# ---------------- the epoch loop ----------------


def _tiny_port_state():
    tm = TorchDINO(**KW, use_remat=True)
    tm.init_params(torch.Generator().manual_seed(0))
    return create_train_state(tm, Optimizer(tm, lr=LR,
                                            lr_backbone=LR_BACKBONE))


def test_train_one_epoch_on_synthetic_batches():
    """engine.train_one_epoch over synthetic paired batches: the weighted
    loss terms among the mean metrics are exactly the weight dict's, all
    finite, one step per batch."""
    from datr_torch.engine import train_one_epoch

    # labels 1..K-1 of the model's K classes
    src = tsynth.SyntheticDetectionDataset(4, (60, 90), K - 1, seed=0)
    tgt = tsynth.SyntheticDetectionDataset(4, (60, 90), K - 1, seed=1,
                                           fog=0.35)
    batches = [tsynth.synthetic_da_batch(src, tgt, [2 * i, 2 * i + 1],
                                         (64, 96), max_boxes=6, device="cpu")
               for i in range(2)]
    state = _tiny_port_state()
    ccfg = tcrit.CriterionCfg(num_classes=K, dn_single_pad=2, dn_groups=2)
    wd = tcrit.build_weight_dict(dec_layers=2)
    metrics = train_one_epoch(state, batches, ccfg, wd)
    weighted = {k for k in metrics if k.startswith("loss_")
                and not k.startswith(("loss_xy", "loss_hw"))}
    assert weighted == set(wd) and "grad_norm" in metrics
    assert all(np.isfinite(v) for v in metrics.values())
    assert state.step == 2 and state.amount.sum().item() > 0


def test_train_one_epoch_stops_on_a_non_finite_loss():
    from datr_torch.engine import train_one_epoch

    batch = {k: t(v) for k, v in _tiny_batch().items()}
    batch["images"][0, 0, 0, 0] = float("nan")
    with pytest.raises(SystemExit):
        train_one_epoch(_tiny_port_state(), [batch],
                        tcrit.CriterionCfg(num_classes=K, dn_single_pad=2,
                                           dn_groups=2),
                        tcrit.build_weight_dict(dec_layers=2))


# ---------------- single-domain training ----------------


def test_train_step_plain_matches_datr_tpu(step):
    """One single-domain step (no DA branch, the whole batch supervised)
    from the same weights and CDN draws as datr_tpu's train_step_plain:
    every loss and grad_norm within test_train_step_losses' tolerances,
    every parameter within 2 lr of datr_tpu's after the AdamW step (as in
    test_train_step_update_and_prototypes), the prototype state untouched."""
    from datr_tpu.train.steps import train_step_plain as jax_train_step_plain
    from datr_torch.train.steps import train_step_plain

    b = _tiny_batch()
    batch = {k: v[:2] for k, v in b.items()}  # 2 images, both supervised
    params = step["params"]
    tx = make_optimizer(params, lr=LR, lr_backbone=LR_BACKBONE)
    jstate = jax_train_state(params, tx, K, HD, jax.random.PRNGKey(5))
    ccfg = jcrit.CriterionCfg(num_classes=K, dn_single_pad=2, dn_groups=2)
    wd = jcrit.build_weight_dict(dec_layers=2)
    _, dn_rng = jax.random.split(jstate.rng)  # datr_tpu/train/steps.py:31-33
    jm = JaxDINO(**KW, dn_labelbook_size=K, use_remat=False)
    # the step donates its state: a copy keeps the fixture's params alive
    new_state, want = jax.device_get(jax_train_step_plain(
        jax.tree.map(jnp.copy, jstate),
        {k: jnp.asarray(v) for k, v in batch.items()}, jm, tx, ccfg, wd))

    tm = TorchDINO(**KW, dn_labelbook_size=K)
    assert load_flax_params(tm, params) == []
    pstate = create_train_state(tm, Optimizer(tm, lr=LR,
                                              lr_backbone=LR_BACKBONE))
    groups, _ = tcdn.cdn_layout(KW["dn_number"], KW["dn_single_pad"])
    got = train_step_plain(
        pstate, {k: t(v) for k, v in batch.items()},
        tcrit.CriterionCfg(num_classes=K, dn_single_pad=2, dn_groups=2),
        tcrit.build_weight_dict(dec_layers=2),
        dn_draws=_jax_cdn_draws(dn_rng, 2, groups, KW["dn_single_pad"], K))
    assert set(got) == set(want)
    assert not any("_DA" in k for k in got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    new = state_dict_from_flax(new_state.params)
    for n, p in pstate.model.state_dict().items():
        group = param_group(n)
        lr = LR if group == "main" else LR_BACKBONE
        tol = 0.0 if group == "frozen" else 2 * lr + 1e-6
        assert (p - new[n]).abs().max().item() <= tol, n
    assert pstate.step == 1 and pstate.amount.sum().item() == 0
