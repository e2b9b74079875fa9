"""The port's evaluation loop and checkpoints against datr_tpu on the CPU:
the CocoEvaluator copy, the eval batches, engine.evaluate and engine.test
with converted parameters, BestTracker's decisions and log, and the
checkpoint round trips. Inputs come from numpy seeds; each test states its
tolerance."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)

from datr_torch import engine as tengine
from datr_torch.convert import load_flax_params
from datr_torch.data import synthetic as tsynth
from datr_torch.eval.coco_eval import CocoEvaluator as TorchCocoEvaluator
from datr_torch.models.dino import DINO as TorchDINO
from datr_torch.models.resnet import FrozenBatchNorm
from datr_torch.train import checkpoint as tckpt
from datr_torch.train.optim import Optimizer
from datr_torch.train.state import EMA_TRACKS, create_train_state
from datr_torch.train.steps import eval_step
from datr_tpu import engine as jengine
from datr_tpu.data.loader import EvalLoader
from datr_tpu.eval.coco_eval import CocoEvaluator as JaxCocoEvaluator
from datr_tpu.models.dino import DINO as JaxDINO
from datr_tpu.train import checkpoint as jckpt

K, HD = 4, 32
KW = dict(num_classes=K, num_queries=12, hidden_dim=HD, nheads=4,
          enc_layers=1, dec_layers=2, dim_feedforward=64, dn_number=4,
          dn_single_pad=2)
CANVAS = (64, 96)


def _dataset(n=5):
    # labels 1..K-1 of the model's K classes, images of two sizes in turn
    # would need a resize; one size that fits the canvas keeps them exact
    return tsynth.SyntheticDetectionDataset(n, (60, 90), K - 1, seed=3,
                                            max_objects=3, fog=0.2)


# ---------------- the evaluator and the batches ----------------


def _detections(rng, n_img=6):
    """Per image: GT (some crowd, annotation areas) and detections near
    them, with tied scores and other classes among them."""
    out = []
    for i in range(n_img):
        g = int(rng.integers(1, 6))
        xy = rng.random((g, 2)) * 300
        wh = rng.random((g, 2)) * 150 + 10
        gt = np.concatenate([xy, xy + wh], 1)
        gl = rng.integers(0, 3, g)
        crowd = rng.random(g) < 0.15
        areas = (wh[:, 0] * wh[:, 1]) * rng.uniform(0.6, 1.0, g)
        d = int(rng.integers(0, 12))
        src = rng.integers(0, g, d)
        db = gt[src] + rng.normal(0, 12, (d, 4))
        ds = np.round(rng.random(d), 2)  # ties
        dl = np.where(rng.random(d) < 0.8, gl[src], rng.integers(0, 3, d))
        out.append(dict(image_id=10 + i, gt_boxes=gt, gt_labels=gl,
                        gt_iscrowd=crowd, gt_areas=areas, det_boxes=db,
                        det_scores=ds, det_labels=dl))
    return out


def test_coco_evaluator_copy_equal():
    """The copy's 12 stats equal datr_tpu's on seeded detections (crowd
    GT, annotation areas, score ties, an image without detections)."""
    recs = _detections(np.random.default_rng(0))
    want_ev, got_ev = JaxCocoEvaluator([0, 1, 2]), TorchCocoEvaluator(
        [0, 1, 2])
    for r in recs:
        want_ev.add_image(**r)
        got_ev.add_image(**r)
    want, got = want_ev.summarize(), got_ev.summarize()
    assert got == want
    assert 0 < want[1] < 1


def test_synthetic_eval_batches_match_eval_loader():
    """The eval batches equal datr_tpu's EvalLoader over the same images
    (no resize): every key, the padded tail batch included; normalized
    pixels atol 1e-6."""
    ds = _dataset()
    got = tsynth.synthetic_eval_batches(ds, 2, CANVAS, max_boxes=4,
                                        device="cpu")
    want = list(EvalLoader(ds, 2, CANVAS, lambda img, tgt: (img, tgt),
                           max_boxes=4, num_threads=1))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].shape == w[k].shape, k
            np.testing.assert_allclose(g[k].numpy(), w[k], rtol=0, atol=1e-6,
                                       err_msg=k)
    assert got[-1]["batch_valid"].tolist() == [True, False]


# ---------------- evaluate / test with converted parameters ----------------


@pytest.fixture(scope="module")
def models():
    """datr_tpu's tiny model (eval init) and the port's with its weights;
    the class head's bias spread so the classes score apart, and the box
    heads' last layers off their zero init."""
    jm = JaxDINO(**KW, dn_labelbook_size=K, use_remat=False)
    x = jnp.zeros((2, *CANVAS, 3))
    params = jax.device_get(jax.jit(lambda key: jm.init(
        key, x, jnp.zeros((2, *CANVAS), bool)))(jax.random.PRNGKey(4)))
    rng = np.random.default_rng(5)
    p = params["params"]
    p["class_head"]["bias"] = rng.uniform(-3, 1, K).astype(np.float32)
    for head in ("bbox_head", "enc_out_bbox_head"):
        for k in ("kernel", "bias"):
            v = p[head]["layer2"][k]
            p[head]["layer2"][k] = (rng.standard_normal(v.shape)
                                    * 0.2).astype(np.float32)
    tm = TorchDINO(**KW, dn_labelbook_size=K)
    load_flax_params(tm, params)
    return jm, params, tm.eval()


def _loaders(tm, n=5):
    """Eval batches of the synthetic images (port, numpy) whose GT is
    moved onto the model's own top detections, jittered: a random model
    finds none of the painted boxes, and the stats should not be all 0."""
    ds = _dataset(n)
    tb = tsynth.synthetic_eval_batches(ds, 2, CANVAS, max_boxes=4,
                                       device="cpu")
    rng = np.random.default_rng(6)
    for b in tb:
        res = eval_step(tm, b, num_select=3)
        oh, ow = b["orig_sizes"][0].tolist()
        x0, y0, x1, y1 = (res["boxes"] / torch.tensor([ow, oh, ow, oh])
                          ).clamp(0, 1).unbind(-1)
        box = torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0],
                          -1)
        jit = torch.from_numpy(rng.normal(0, 0.08, box.shape)).float()
        box = torch.cat([box[..., :2] + jit[..., :2] * box[..., 2:],
                         box[..., 2:] * jit[..., 2:].exp()], -1)
        b["boxes"][:, :3], b["labels"][:, :3] = box, res["labels"]
        b["valid"][:] = False
        b["valid"][:, :3] = True
    return tb, [{k: v.numpy() for k, v in b.items()} for b in tb]


@pytest.mark.parametrize("nms", [-1.0, 0.5])
def test_evaluate_equal(models, nms):
    """engine.evaluate on the same batches with converted parameters: the
    12 stats within 1e-3 of datr_tpu's, with and without the eval NMS."""
    jm, params, tm = models
    tb, jb = _loaders(tm)
    want = jengine.evaluate(params, jm, jb, range(K), num_select=30,
                            nms_iou_threshold=nms)
    got = tengine.evaluate(tm, tb, range(K), num_select=30,
                           nms_iou_threshold=nms)
    np.testing.assert_allclose(got["coco_eval_bbox"],
                               want["coco_eval_bbox"], rtol=0, atol=1e-3)
    assert got["ap50"] == got["coco_eval_bbox"][1]
    assert 0 < want["coco_eval_bbox"][1] < 1


@pytest.mark.parametrize("nms", [-1.0, 0.5])
def test_test_dump_equal(models, tmp_path, nms):
    """engine.test's records: the same (image, category) pairs, each
    detection's cxcywh box within 1e-3 pixel and score within 1e-5 of
    datr_tpu's (matched by rank within its image and class), and the
    results file holds them."""
    jm, params, tm = models
    tb, jb = _loaders(tm, 3)
    want = jengine.test(params, jm, jb, None, num_select=20,
                        nms_iou_threshold=nms)
    got = tengine.test(tm, tb, str(tmp_path), num_select=20,
                       nms_iou_threshold=nms)
    assert json.loads((tmp_path / "results0.json").read_text()) == got

    def key(r):
        return (r["image_id"], r["category_id"], -r["score"])

    got, want = sorted(got, key=key), sorted(want, key=key)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["image_id"], g["category_id"]) == (w["image_id"],
                                                     w["category_id"])
        np.testing.assert_allclose(g["score"], w["score"], atol=1e-5)
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-3)


# ---------------- BestTracker and the checkpoints ----------------


def test_best_tracker_matches_datr_tpu(tmp_path):
    """The same AP50 sequence over two families: the same decisions, the
    same log_best.txt lines, the same `best`; a NaN never improves."""
    seq = [("best_ema_teacher", 0.1), ("checkpoint_best_regular", 0.05),
           ("best_ema_teacher", 0.1), ("best_ema_teacher", 0.3),
           ("checkpoint_best_regular", 0.01), ("best_ema_teacher",
                                               float("nan")),
           ("checkpoint_best_regular", 0.2)]
    jt = jckpt.BestTracker(str(tmp_path / "jax"),
                           initial_best={"best_ema_teacher": 0.08})
    tt = tckpt.BestTracker(str(tmp_path / "torch"),
                           initial_best={"best_ema_teacher": 0.08})
    tree = {"w": np.arange(3, dtype=np.float32)}
    sd = {"w": torch.arange(3, dtype=torch.float32)}
    for epoch, (fam, ap) in enumerate(seq):
        assert tt.update(fam, ap, sd, epoch) == jt.update(fam, ap, tree,
                                                          epoch)
    jckpt.wait_for_async_saves()
    assert tt.best == jt.best
    assert (tmp_path / "torch" / "log_best.txt").read_text() == (
        tmp_path / "jax" / "log_best.txt").read_text()
    meta = json.loads((tmp_path / "torch" /
                       "best_ema_teacher.meta.json").read_text())
    assert meta == {"epoch": 3, "ap50": 0.3}


class TinyNet(torch.nn.Module):
    """Stands in for DINO in the checkpoint tests (a full ResNet-50 per
    track would make each checkpoint hundreds of MB): a backbone layer, a
    frozen batch-norm (buffers), a frozen stem, a head and the DA heads."""

    num_classes, hidden_dim = K, 6

    def __init__(self, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.backbone = torch.nn.Module()
        self.backbone.conv1 = torch.nn.Linear(6, 6)
        self.backbone.layer2_block0 = torch.nn.Linear(6, 6)
        self.backbone.bn1 = FrozenBatchNorm(6)
        self.class_head = torch.nn.Linear(6, K)
        self.d_img = torch.nn.Linear(6, 1)
        self.proto_d = torch.nn.Linear(6, 1)
        for t in self.state_dict().values():
            t.copy_(torch.randn(t.shape, generator=g))


def _trained_state(seed):
    """A state after one AdamW update (moments and step count moved), with
    EMA tracks that differ from the model, moved prototypes, counters and
    CDN generator."""
    state = create_train_state(TinyNet(seed), Optimizer(TinyNet(seed)),
                               seed=seed)
    state.optimizer = Optimizer(state.model)
    g = torch.Generator().manual_seed(seed + 100)
    for p in state.model.parameters():
        if p.requires_grad:
            p.grad = torch.randn(p.shape, generator=g)
    state.optimizer.step(0)
    for name in EMA_TRACKS:
        for t in getattr(state, name).state_dict().values():
            t.add_(torch.randn(t.shape, generator=g))
    state.global_proto = torch.randn(K, 6, generator=g)
    state.amount = torch.rand(K, generator=g)
    state.step, state.ema_updates = 1, 3
    torch.rand(5, generator=state.dn_generator)
    return state


def _all_tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for name in EMA_TRACKS:
        out.update({f"{name}.{k}": v
                    for k, v in getattr(state, name).state_dict().items()})
    for i, s in state.optimizer.opt.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in s.items()})
    out["global_proto"], out["amount"] = state.global_proto, state.amount
    out["generator"] = state.dn_generator.get_state()
    return out


def test_checkpoint_round_trip_bitwise(tmp_path):
    """save_checkpoint -> maybe_auto_resume into a state of other weights:
    every tensor (model, EMA tracks, AdamW moments, prototypes, the CDN
    generator) comes back bitwise, with the counters and the meta."""
    a, b = _trained_state(0), _trained_state(1)
    tckpt.save_checkpoint(str(tmp_path / "checkpoint"), a, 4,
                          {"best": {"best_ema_teacher": 0.2}})
    b, start, meta = tckpt.maybe_auto_resume(str(tmp_path), b)
    assert start == 5 and meta == {"epoch": 4,
                                   "best": {"best_ema_teacher": 0.2}}
    ta, tb = _all_tensors(a), _all_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert (b.step, b.ema_updates) == (a.step, a.ema_updates) == (1, 3)
    assert tckpt.maybe_auto_resume(str(tmp_path / "none"), b)[1:] == (0, {})


def test_load_resume_both_kinds(tmp_path):
    """load_resume of a whole state resumes its epoch; of a best family
    (one module's weights) loads them into the model and all three EMA
    tracks bitwise and starts at epoch 0, the optimizer untouched."""
    a = _trained_state(0)
    tckpt.save_checkpoint(str(tmp_path / "checkpoint0007"), a, 7)
    tckpt.BestTracker(str(tmp_path)).update("best_ema_teacher", 0.4,
                                            a.ema_teacher, 7)
    b, start, _ = tckpt.load_resume(str(tmp_path / "checkpoint0007"),
                                    _trained_state(1))
    assert start == 8 and b.step == 1
    c = _trained_state(1)
    moments = {k: v.clone() for k, v in _all_tensors(c).items()
               if k.startswith("opt.")}
    c, start, meta = tckpt.load_resume(str(tmp_path / "best_ema_teacher"), c)
    assert start == 0 and meta == {"epoch": 7, "ap50": 0.4}
    want = a.ema_teacher.state_dict()
    for m in (c.model, *(getattr(c, n) for n in EMA_TRACKS)):
        for k, v in m.state_dict().items():
            assert torch.equal(v, want[k]), k
    for k, v in moments.items():
        assert torch.equal(_all_tensors(c)[k], v), k


def test_load_pretrain_params_fills_da_heads_and_checks_shapes(tmp_path):
    """A params-only tree without the DA heads takes them from the model;
    a wrong shape or an unknown name fails; a whole state gives its
    model's weights."""
    a = _trained_state(0)
    sd = {k: v for k, v in a.model.state_dict().items()
          if not k.startswith(("d_img.", "proto_d."))}
    tckpt.save_checkpoint(str(tmp_path / "eval_only"), sd, 0)
    target = TinyNet(3)
    got = tckpt.load_pretrain_params(str(tmp_path / "eval_only"), target)
    own = target.state_dict()
    for k, v in got.items():
        ref = own[k] if k.startswith(("d_img.", "proto_d.")) else \
            a.model.state_dict()[k]
        assert torch.equal(v, ref), k
    bad = dict(sd, **{"class_head.weight": sd["class_head.weight"].T})
    tckpt.save_checkpoint(str(tmp_path / "bad"), bad, 0)
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_pretrain_params(str(tmp_path / "bad"), target)
    tckpt.save_checkpoint(str(tmp_path / "extra"), dict(sd, foo=sd[
        "class_head.bias"]), 0)
    with pytest.raises(ValueError, match="foo"):
        tckpt.load_pretrain_params(str(tmp_path / "extra"), target)
    tckpt.save_checkpoint(str(tmp_path / "whole"), a, 0)
    got = tckpt.load_pretrain_params(str(tmp_path / "whole"), target)
    for k, v in a.model.state_dict().items():
        assert torch.equal(got[k], v), k
