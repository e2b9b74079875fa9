"""The port's instance-mask model against datr_tpu on the CPU: the
attention map, the nearest resize, the mask head (unchunked, chunked by a
divisor and by a non-divisor of B x Q), the mask losses, the criterion's
masks term and weight dict, the eval forward with masks, the flax tree's
mask parameters, and one train_step_plain on a batch with instance masks.

datr_tpu runs in f32 on JAX-CPU at hidden 128 with 8 heads (GroupNorm(8)
needs C / 16 >= 8 channels, as tests/test_masks_data.py:236-239 notes), 1
encoder and 2 decoder layers, 12 queries, a ResNet of one bottleneck block
per stage (RESNET_STAGES patched on both sides), a 64x96 canvas (stride 4:
16x24, stride 32: 2x3). Its parameters are seeded numpy draws over
`jax.eval_shape`'s tree, carried into the port by `load_flax_params`; each
reference is jitted once at XLA's lowest backend optimization level.
Tolerances: the attention map atol 1e-5, the head's logits atol 1e-4, the
losses rtol 1e-5, the eval forward's pred_masks atol 1e-3 (logits 2e-3 and
boxes 1e-4, tests/test_torch_parity.py's), the train step's losses 1e-4
relative and every gradient by norm 1e-3."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)
from flax import linen as fnn

from datr_torch.convert import load_flax_params, state_dict_from_flax
from datr_torch.models import cdn as tcdn
from datr_torch.models import dino as tdino
from datr_torch.models import segmentation as tseg
from datr_torch.train import criterion as tcrit
from datr_torch.train.optim import Optimizer
from datr_torch.train.state import create_train_state
from datr_torch.train.steps import plain_loss_and_grads, train_step_plain
from datr_tpu.models import dino as jdino
from datr_tpu.models import segmentation as jseg
from datr_tpu.train import criterion as jcrit

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_bf16 import seeded_params  # noqa: E402
from test_torch_port_train import _jax_cdn_draws  # noqa: E402

CANVAS = (64, 96)
K, C, NH = 4, 128, 8
KW = dict(num_classes=K, num_queries=12, hidden_dim=C, nheads=NH,
          enc_layers=1, dec_layers=2, dim_feedforward=128, dn_number=2,
          dn_single_pad=2, dn_labelbook_size=K)
STAGES = (1, 1, 1, 1)  # one bottleneck block per ResNet stage, both sides
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
LOGIT_ATOL, BOX_ATOL, MASK_ATOL = 2e-3, 1e-4, 1e-3


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", autouse=True)
def small_backbone():
    mp = pytest.MonkeyPatch()
    mp.setitem(jdino.RESNET_STAGES, "resnet50", STAGES)
    mp.setitem(tdino.RESNET_STAGES, "resnet50", STAGES)
    yield
    mp.undo()


def _images(rng, b=2):
    img = rng.standard_normal((b, *CANVAS, 3)).astype(np.float32)
    pm = np.zeros((b, *CANVAS), bool)
    pm[0, 52:] = True
    pm[1, :, 70:] = True
    img[pm] = 0.0
    return img, pm


# ---------------- the head's parts ----------------


class _JaxHead(fnn.Module):
    """datr_tpu's mask_head_forward over its two submodules, named as in
    its DINO (bbox_attention, mask_head)."""
    chunk: int = 0

    @fnn.compact
    def __call__(self, hs, src, mem, mask, fpns):
        return jseg.mask_head_forward(
            jseg.MHAttentionMap(C, NH, name="bbox_attention"),
            jseg.MaskHeadSmallConv(C + NH, C, name="mask_head"),
            hs, src, mem, mask, fpns, query_chunk=self.chunk)


class _TorchHead(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.bbox_attention = tseg.MHAttentionMap(C, NH)
        self.mask_head = tseg.MaskHeadSmallConv(C + NH, C, (96, 48, 24))


def _head_inputs(seed=0, b=2, q=6):
    """hs [b, q, C], the projected stride-32 source and memory (2x3, one
    padded column on image 1), and C4 / C3 / C2 laterals of 96 / 48 / 24
    channels at 4x6 / 8x12 / 16x24 (NHWC, datr_tpu's layout)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    mask = np.zeros((b, 2, 3), bool)
    mask[1, :, 2] = True
    return (f(b, q, C), f(b, 2, 3, C), f(b, 2, 3, C), mask,
            [f(b, 4, 6, 96), f(b, 8, 12, 48), f(b, 16, 24, 24)])


@pytest.fixture(scope="module")
def head():
    hs, src, mem, mask, fpns = _head_inputs()
    shapes = jax.eval_shape(lambda k: _JaxHead().init(
        k, hs, src, mem, mask, fpns), jax.random.PRNGKey(0))
    params = {"params": seeded_params(shapes["params"], seed=1)}
    th = _TorchHead()
    th.load_state_dict(state_dict_from_flax(params))
    return params, th


def test_attention_map_matches_datr_tpu(head):
    """MHAttentionMap: the joint softmax over heads x space, -inf on the
    padded column, atol 1e-5; a padded cell gets exactly 0."""
    params, th = head
    hs, _, mem, mask, _ = _head_inputs(2)
    want = jax.jit(lambda p: jseg.MHAttentionMap(C, NH).apply(
        {"params": p["params"]["bbox_attention"]}, hs, mem, mask),
        compiler_options=FAST)(params)
    with torch.no_grad():
        got = th.bbox_attention(t(hs), t(mem), t(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert (got[1, :, :, :, 2] == 0).all()
    np.testing.assert_allclose(got.sum((2, 3, 4)).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("hw,size", [((2, 3), (4, 6)), ((5, 7), (9, 13)),
                                     ((7, 9), (16, 24)), ((3, 5), (8, 11))])
def test_nearest_resize_matches_datr_tpu(hw, size):
    """floor(i * in / out), equal at odd sizes."""
    x = np.random.default_rng(3).standard_normal((2, *hw, 5)).astype(
        np.float32)
    want = np.asarray(jseg.nearest_resize_torch(jnp.asarray(x), size))
    got = tseg.nearest_resize_torch(t(x).permute(0, 3, 1, 2), size)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("chunk", [0, 4, 5, 100])
def test_mask_head_matches_datr_tpu(head, chunk):
    """The mask head's stride-4 logits, atol 1e-4: the whole fan-out
    (0), chunks of a divisor of B x Q = 12 (4), of a non-divisor (5,
    rounded down to 4), and a chunk above B x Q (one pass). The port's
    chunked logits equal its unchunked ones to 1e-6."""
    params, th = head
    hs, src, mem, mask, fpns = _head_inputs(4)
    want = jax.jit(lambda p: _JaxHead(chunk).apply(
        p, hs, src, mem, mask, fpns), compiler_options=FAST)(params)
    nchw = lambda x: t(x).permute(0, 3, 1, 2)  # noqa: E731
    args = (th.bbox_attention, th.mask_head, t(hs), nchw(src), t(mem),
            t(mask), [nchw(f) for f in fpns])
    with torch.no_grad():
        got = tseg.mask_head_forward(*args, query_chunk=chunk)
        whole = tseg.mask_head_forward(*args)
    assert got.shape == (2, 6, 16, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)
    assert tseg._divisor_chunk(5, 12) == 4 and tseg._divisor_chunk(7, 7) == 7


# ---------------- the losses and the criterion ----------------


def _loss_inputs(seed=0, b=2, n=7, tt=3, grid=(16, 24)):
    rng = np.random.default_rng(seed)
    pred = (3 * rng.standard_normal((b, n, 16, 24))).astype(np.float32)
    gt = rng.random((b, tt, *grid)).astype(np.float16)
    gt[gt < 0.5] = 0
    valid = np.ones((b, tt), bool)
    valid[1, 2] = False
    assign = rng.integers(0, n, (b, tt)).astype(np.int32)
    return pred, gt, valid, assign, np.float32(5.0)


@pytest.mark.parametrize("grid", [(16, 24), (8, 12)])
def test_mask_losses_match_datr_tpu(grid):
    """dice_loss, mask_focal_loss and loss_masks, rtol 1e-5; the targets'
    own grid (no resize) and a coarser one (bilinear, antialiased as
    jax.image.resize downscales)."""
    pred, gt, valid, assign, nb = _loss_inputs(grid=grid)
    want = jax.device_get(jseg.loss_masks(
        jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(valid),
        jnp.asarray(assign), nb))
    got = tseg.loss_masks(t(pred), t(gt), t(valid), t(assign), t(nb))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), want[k], rtol=1e-5,
                                   err_msg=k)
    flat_p, flat_g = pred[:, :3].reshape(6, -1), np.resize(
        gt.astype(np.float32), (6, 16 * 24))
    pv = valid.reshape(-1)
    for name in ("dice_loss", "mask_focal_loss"):
        w = getattr(jseg, name)(jnp.asarray(flat_p), jnp.asarray(flat_g), nb,
                                jnp.asarray(pv))
        g = getattr(tseg, name)(t(flat_p), t(flat_g), t(nb), t(pv))
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5,
                                   err_msg=name)


def test_criterion_masks_term_and_weights():
    """The criterion with gt_masks on the same outputs: every key of
    datr_tpu's loss dict (loss_mask / loss_dice on the final layer's
    assignment), rtol 1e-5 / atol 1e-6; build_weight_dict(masks=True)
    equal."""
    rng = np.random.default_rng(7)
    b, n, tt = 2, 12, 3
    c = rng.random((2, b, n, 2)) * 0.5 + 0.25
    boxes = np.concatenate([c, rng.random((2, b, n, 2)) * 0.3 + 0.1], -1)
    gtc = rng.random((b, tt, 2)) * 0.5 + 0.25
    gt_boxes = np.concatenate([gtc, rng.random((b, tt, 2)) * 0.3 + 0.1],
                              -1).astype(np.float32)
    out = {"pred_logits": rng.standard_normal((b, n, K)),
           "pred_boxes": boxes[0],
           "aux_logits": rng.standard_normal((1, b, n, K)),
           "aux_boxes": boxes[1][None],
           "interm_logits": rng.standard_normal((b, n, K)),
           "interm_boxes": boxes[1],
           "pred_masks": 2 * rng.standard_normal((b, n, 16, 24))}
    out = {k: np.asarray(v, np.float32) for k, v in out.items()}
    gt_masks = (rng.random((b, tt, 16, 24)) > 0.6).astype(np.float16)
    labels = rng.integers(0, K, (b, tt)).astype(np.int32)
    valid = np.array([[True, True, True], [True, False, False]])
    want = jax.device_get(jax.jit(lambda o, lb, bx, v, gm: jcrit.criterion(
        o, lb, bx, v, jcrit.CriterionCfg(num_classes=K), gt_masks=gm),
        compiler_options=FAST)(out, labels, gt_boxes, valid, gt_masks))
    got = tcrit.criterion({k: t(v) for k, v in out.items()}, t(labels),
                          t(gt_boxes), t(valid), tcrit.CriterionCfg(K),
                          gt_masks=t(gt_masks))
    assert set(got) == set(want) and {"loss_mask", "loss_dice"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for kw in (dict(masks=True), dict(masks=True, mask_loss_coef=2.0,
                                      dice_loss_coef=5.0, dec_layers=3)):
        assert (tcrit.build_weight_dict(**kw)
                == jcrit.build_weight_dict(**kw))


# ---------------- the model ----------------


@pytest.fixture(scope="module")
def models(small_backbone):
    """datr_tpu's tiny DINO with masks (train-mode tree: the DA heads and
    the CDN label embedding too), seeded; the port's from the same tree."""
    jm = jdino.DINO(**KW, with_masks=True, use_remat=False)
    img, pm = _images(np.random.default_rng(0))
    tgt = {"boxes": jnp.full((2, 3, 4), 0.3), "labels": jnp.zeros(
        (2, 3), jnp.int32), "valid": jnp.ones((2, 3), bool)}
    shapes = jax.eval_shape(lambda k: jm.init(
        k, img, pm, targets=tgt, dn_rng=jax.random.PRNGKey(1), train=True,
        global_proto=jnp.zeros((K, C)), amount=jnp.zeros((K,)),
        domain_adapt=False), jax.random.PRNGKey(0))
    params = {"params": seeded_params(shapes["params"], seed=2)}
    return jm, params


def _port(params, **kw):
    """The port's model from the tree; only the DA heads, which a
    single-domain init does not create, keep the port's init."""
    tm = tdino.DINO(**KW, with_masks=True, **kw)
    left = load_flax_params(tm, params)
    assert {n.split(".")[0] for n in left} == {"d_img", "proto_d"}
    return tm


def test_flax_tree_carries_the_mask_head(models):
    """Every bbox_attention / mask_head parameter of the port comes from
    the flax tree (load_flax_params leaves none at init), and the
    backbone returns stages 0..3 for the laterals."""
    _, params = models
    sd = state_dict_from_flax(params)
    tm = _port(params)
    names = [n for n, _ in tm.named_parameters()
             if n.split(".")[0] in ("bbox_attention", "mask_head")]
    assert len(names) == 2 * 2 + 2 * (5 + 5 + 3 + 1)
    for n in names:
        np.testing.assert_array_equal(tm.state_dict()[n].numpy(),
                                      sd[n].numpy(), err_msg=n)
    assert tm.backbone_stages == (0, 1, 2, 3)
    assert tdino.DINO(**KW).backbone_stages == (1, 2, 3)


@pytest.mark.parametrize("chunk", [0, 5])
def test_eval_forward_with_masks(models, chunk):
    """The eval forward of a padded batch: pred_masks atol 1e-3, logits
    2e-3, boxes 1e-4, the two-stage selection equal; chunk 5 (not a
    divisor of 24 pairs) through the port only, equal to 1e-5 of its
    whole fan-out."""
    jm, params = models
    img, pm = _images(np.random.default_rng(5))
    want = jax.device_get(jax.jit(lambda p: jm.apply(p, img, pm),
                                  compiler_options=FAST)(params))
    tm = _port(params, mask_query_chunk=chunk).eval()
    with torch.no_grad():
        got = tm(t(img), t(pm))
    assert got["pred_masks"].shape == (2, 12, 16, 24)
    assert got["pred_masks"].dtype == torch.float32
    for key, w in want.items():
        atol = (MASK_ATOL if key == "pred_masks" else LOGIT_ATOL
                if "logits" in key else BOX_ATOL)
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=atol,
                                   err_msg=key)
    if chunk:
        with torch.no_grad():
            whole = _port(params).eval()(t(img), t(pm))["pred_masks"]
        np.testing.assert_allclose(got["pred_masks"].numpy(),
                                   whole.numpy(), rtol=0, atol=1e-5)


def _mask_batch():
    """2 supervised images at 64x96 with 3 targets each (one padding), and
    soft f16 stride-4 mask targets."""
    rng = np.random.default_rng(11)
    img, pm = _images(rng)
    c = rng.random((2, 3, 2)) * 0.5 + 0.25
    boxes = np.concatenate([c, rng.random((2, 3, 2)) * 0.3 + 0.1],
                           -1).astype(np.float32)
    valid = np.ones((2, 3), bool)
    valid[1, 2] = False
    masks = rng.random((2, 3, 16, 24))
    masks = np.where(masks > 0.55, masks, 0).astype(np.float16)
    return dict(images=img, pad_mask=pm, boxes=boxes,
                labels=rng.integers(0, K, (2, 3)).astype(np.int32),
                valid=valid, masks=masks)


def test_train_step_plain_with_masks(models):
    """One train_step_plain on a batch with instance masks against the
    loss and gradients of datr_tpu's train_step_plain body
    (datr_tpu/train/steps.py:103-125: the single-domain forward, the
    criterion with gt_masks, value_and_grad), the same CDN draws: every
    loss within 1e-4 relative (atol 1e-6), every gradient, the mask
    head's included, within 1e-3 of datr_tpu's by norm (atol 1e-6)."""
    jm, params = models
    batch = _mask_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    groups, _ = tcdn.cdn_layout(KW["dn_number"], KW["dn_single_pad"])
    ccfg = jcrit.CriterionCfg(num_classes=K, dn_single_pad=2,
                              dn_groups=groups)
    wd = jcrit.build_weight_dict(dec_layers=2, masks=True)
    dn_rng = jax.random.PRNGKey(7)

    def loss_fn(p):
        out = jm.apply(p, jb["images"], jb["pad_mask"],
                       targets={k: jb[k] for k in ("boxes", "labels",
                                                   "valid")},
                       dn_rng=dn_rng, train=True, domain_adapt=False)
        losses = jcrit.criterion(out, jb["labels"], jb["boxes"],
                                 jb["valid"], ccfg, gt_masks=jb["masks"])
        return jcrit.weighted_total(losses, wd), losses

    (total, want), grads = jax.device_get(jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True),
        compiler_options=FAST)(params))
    assert {"loss_mask", "loss_dice"} <= set(want)

    tb = {k: t(v) for k, v in batch.items()}
    tccfg = tcrit.CriterionCfg(num_classes=K, dn_single_pad=2,
                               dn_groups=groups)
    twd = tcrit.build_weight_dict(dec_layers=2, masks=True)
    draws = _jax_cdn_draws(dn_rng, 2, groups, 2, K)
    tm = _port(params)
    state = create_train_state(tm, Optimizer(tm, lr=1e-4, lr_backbone=1e-5))
    p_total, got, _ = plain_loss_and_grads(state, tb, tccfg, twd, draws)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), want[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(p_total.item(), total, rtol=1e-4)
    ref = state_dict_from_flax(grads)
    mask_params = 0
    for n, p in state.model.named_parameters():
        if p.grad is None:
            continue
        mask_params += n.startswith(("mask_head", "bbox_attention"))
        err = (p.grad - ref[n]).norm().item()
        assert err <= 1e-3 * ref[n].norm().item() + 1e-6, (n, err)
    assert mask_params == 32
    metrics = train_step_plain(state, tb, tccfg, twd, dn_draws=draws)
    for k in want:
        np.testing.assert_allclose(metrics[k].item(), want[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert state.step == 1
