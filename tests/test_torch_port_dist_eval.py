"""The port's evaluation across processes on the CPU: `engine.evaluate` on
two gloo ranks (tests/torch_port_dist_worker.py, spawned; no rank imports
JAX), each on its shard of the images (the eval loader's
`process_index::process_count`, batch counts rounded up alike), merged by
all-gathers so that every rank computes the global stats. Held against the
one-process `evaluate` of the same model and images, and the merges
themselves against datr_tpu's (`_merge_across_processes`,
`_merge_segm_across_processes`) on the same records.

The model is tests/test_torch_port_masks.py's (hidden 128, 8 heads,
instance masks; a ResNet of one bottleneck block per stage) with seeded
weights; the COCO tree's GT are that model's own detections and masks (a
seeded model finds nothing painted), so the APs are above 0. 5 images over
2 ranks: one rank evaluates a padded batch."""

import json
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)
from jax.experimental import multihost_utils

from datr_torch import engine as tengine
from datr_torch.data import coco as tcoco
from datr_torch.data import loader as tloader
from datr_torch.data import transforms as ttf
from datr_torch.data.synthetic import SyntheticDetectionDataset
from datr_torch.eval.coco_eval import CocoEvaluator as TEvaluator
from datr_torch.models import dino as tdino
from datr_torch.models import segmentation as tseg
from datr_torch.parallel import dist as pdist
from datr_torch.train.steps import eval_step
from datr_torch.utils import rle as trle
from datr_tpu import engine as jengine
from datr_tpu.eval.coco_eval import CocoEvaluator as JEvaluator

sys.path.insert(0, os.path.dirname(__file__))
import torch_port_dist_worker as worker  # noqa: E402
from test_torch_port_masks import KW, STAGES  # noqa: E402
from test_torch_port_masks_data import _write_masks_coco  # noqa: E402

WORLD = 2
N_IMAGES = 5
CANVAS = (96, 128)
EVAL_MAX = (80, 120)
MAX_BOXES = 4
NUM_SELECT = 20
SYNTHETIC = dict(n_images=N_IMAGES, hw=(70, 90),
                 num_classes=KW["num_classes"] - 1, seed=1, fog=0.35)
# (name, dataset, batch size, segm, eval NMS threshold)
CASES = (("coco_b1", "coco", 1, True, -1.0),
         ("coco_b2", "coco", 2, True, -1.0),
         ("synthetic_nms", "synthetic", 2, False, 0.5))


def _gt_from_own_detections(model, root):
    """Rewrite the val annotations with the model's own top detections
    and masks (3 per image), one process, batch 1."""
    ds = tcoco.build_dataset("val", "single", str(root))
    ann_path = root / "single" / "val" / "annotations.json"
    ann = json.loads(ann_path.read_text())
    ann["annotations"] = []
    for b in tloader.make_eval_loader(ds, 1, CANVAS,
                                      ttf.EvalTransform(*EVAL_MAX),
                                      MAX_BOXES, num_threads=1):
        res = eval_step(model, {k: torch.from_numpy(v) for k, v in
                                b.items()}, num_select=3, with_masks=True)
        oh, ow = (int(v) for v in b["orig_sizes"][0])
        rles = tseg.det_mask_rles(res["mask_logits"][0].float().numpy(),
                                  CANVAS, tuple(b["real_sizes"][0]), (oh, ow))
        for box, lab, c in zip(res["boxes"][0].tolist(),
                               res["labels"][0].tolist(), rles):
            x0, y0, x1, y1 = box
            ann["annotations"].append({
                "id": len(ann["annotations"]),
                "image_id": int(b["image_ids"][0]),
                "bbox": [x0, y0, x1 - x0, y1 - y0], "category_id": lab,
                "area": float(trle.area_of_counts(c)),
                "segmentation": {"size": [oh, ow], "counts": c.tolist()}})
    ann["categories"] = [{"id": c} for c in range(KW["num_classes"])]
    ann_path.write_text(json.dumps(ann))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every case's stats on each rank and in one process."""
    mp = pytest.MonkeyPatch()
    mp.setitem(tdino.RESNET_STAGES, "resnet50", STAGES)
    try:
        yield _run(tmp_path_factory.mktemp("dist_eval"))
    finally:
        mp.undo()


def _run(tmp):
    model = tdino.DINO(**KW, with_masks=True, mask_query_chunk=10)
    model.init_params(torch.Generator().manual_seed(3))
    model.eval()
    root = tmp / "data"
    _write_masks_coco(root / "single", "val", N_IMAGES, 8)
    _gt_from_own_detections(model, root)
    specs = {"coco": ("coco", str(root), "single"),
             "synthetic": ("synthetic", SYNTHETIC)}
    kw = dict(KW, with_masks=True, mask_query_chunk=10)
    tasks = [(f"evaluate:{name}", dict(
        stages=STAGES, kw=kw, sd=model.state_dict(), dataset=specs[data],
        batch_size=bs, canvas=CANVAS, eval_max=EVAL_MAX,
        max_boxes=MAX_BOXES, num_select=NUM_SELECT, segm=segm, nms=nms))
        for name, data, bs, segm, nms in CASES]
    ctx = worker.spawn(tasks, WORLD, tmp / "ranks")
    try:  # the one-process evaluations while the ranks run
        one = {}
        for name, data, bs, segm, nms in CASES:
            ds, cats = worker.eval_dataset(specs[data])
            one[name] = tengine.evaluate(
                model, tloader.make_eval_loader(
                    ds, bs, CANVAS, ttf.EvalTransform(*EVAL_MAX), MAX_BOXES,
                    num_threads=1), cats, NUM_SELECT, nms_iou_threshold=nms,
                segm=segm)
    finally:
        worker.join(ctx)
    return {name: dict(one=one[name], ranks=worker.results(
        tmp / "ranks", f"evaluate:{name}", WORLD)) for name, *_ in CASES}


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sharded_evaluate_equals_one_process(run, name):
    """Both ranks compute the same stats (equal), and they are the
    one-process evaluate's: to 1e-6 where each rank's batches are batches
    of the one-process run (batch size 1); within 1e-3 otherwise (the
    ranks batch other images together, so products may round otherwise).
    On the COCO tree (GT = the model's own detections) the APs are above 0;
    the seeded model finds none of the synthetic objects, so that case
    holds the GT's travel and the NMS marking, and
    test_merges_equal_datr_tpu holds them at APs above 0."""
    r0, r1 = run[name]["ranks"]
    one = run[name]["one"]
    keys = ("coco_eval_bbox", "coco_eval_masks") if "coco" in name else (
        "coco_eval_bbox",)
    assert set(r0) == set(one) == {*keys, "ap50"}
    atol = 1e-6 if name == "coco_b1" else 1e-3
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        np.testing.assert_allclose(r0[k], one[k], rtol=0, atol=atol,
                                   err_msg=k)
        assert one[k][1] > 0 or "synthetic" in name, (k, one[k])


def test_eval_loader_rounds_the_batch_count_up():
    """5 images in batches of 2 over 2 processes: 3 and 2 images, 2 batches
    each (the second rank's last batch all padding); every image once."""
    ds = SyntheticDetectionDataset(**SYNTHETIC)
    seen = []
    for p in range(WORLD):
        batches = list(tloader.make_eval_loader(
            ds, 2, CANVAS, ttf.EvalTransform(*EVAL_MAX), MAX_BOXES,
            num_threads=1, process_index=p, process_count=WORLD))
        assert len(batches) == 2
        for b in batches:
            seen += list(b["image_ids"][b["batch_valid"]])
    assert sorted(seen) == list(range(N_IMAGES))


# ---------------- the merges against datr_tpu's ----------------


class _Procs:
    """Two simulated processes in two threads: a thread-local process index
    and an all-gather that stacks both threads' arrays (a tuple of arrays,
    or one array) in process order."""

    def __init__(self):
        self.local = threading.local()
        self.barrier = threading.Barrier(WORLD)
        self.slots = [None] * WORLD

    def index(self):
        return self.local.p

    def gather(self, tree):
        self.slots[self.local.p] = tree
        self.barrier.wait()
        both = list(self.slots)
        self.barrier.wait()  # both read before the next call writes
        return jax.tree.map(lambda *xs: np.stack([np.asarray(x)
                                                  for x in xs]), *both)

    def run(self, fn):
        out, errs = [None] * WORLD, []

        def body(p):
            self.local.p = p
            try:
                out[p] = fn(p)
            except BaseException as e:  # noqa: BLE001 (re-raised below)
                errs.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(p,))
                   for p in range(WORLD)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errs:
            raise errs[0]
        return out


def _records(with_raw_gt: bool):
    """4 images' detections (num_select 6, an NMS keep mask) and GT, by
    image id: seeded boxes around 2 GT boxes per image, rectangle masks."""
    rng = np.random.default_rng(9)
    h, w, ns, mb = 40, 50, 6, 3
    recs = {}
    for iid in (11, 12, 13, 14):
        g = np.array([[4 + iid % 3, 5, 24, 20], [20, 18, 40, 36]],
                     np.float64)
        d = np.concatenate([g + rng.integers(-3, 4, (2, 4)),
                            rng.uniform(0, 30, (ns - 2, 4))])
        d[:, 2:] = np.maximum(d[:, 2:], d[:, :2] + 2)
        keep = np.array([True, True, True, False, True, False])
        scores = rng.uniform(0.1, 0.9, ns).astype(np.float32)
        labels = rng.integers(1, 3, ns).astype(np.int32)

        def masks(bx):
            m = np.zeros((len(bx), h, w), np.uint8)
            for i, (x0, y0, x1, y1) in enumerate(bx.astype(int)):
                m[i, y0:y1, x0:x1] = 1
            return trle.masks_to_rles(m)

        gt_xyxy = np.zeros((mb, 4))
        gt_xyxy[:2] = g
        gt_labels = np.array([1, 2, 0], np.int32)
        gt_valid = np.array([True, True, False])
        recs[iid] = dict(
            det=dict(image_id=iid, boxes=d.astype(np.float32),
                     scores=np.where(keep, scores, -1.0).astype(np.float32),
                     labels=labels),
            keep=keep, rles=masks(d[keep]),
            gt=dict(boxes=g, labels=np.array([1, 2]),
                    iscrowd=np.array([False, False]),
                    areas=np.array([300.0, 400.0]), masks=masks(g),
                    mask_size=(h, w)),
            batch_gt=dict(gt_boxes=gt_xyxy, gt_labels=gt_labels,
                          gt_valid=gt_valid))
        if not with_raw_gt:
            recs[iid]["det"].update(recs[iid]["batch_gt"])
    return recs


def _raw_gt(recs):
    def raw_gt(iid, with_masks=False):
        gt = dict(recs[iid]["gt"])
        if not with_masks:
            gt.pop("masks")
            gt.pop("mask_size")
        return gt
    return raw_gt


def _add_local(ev, r, raw_gt, segm):
    d, keep = r["det"], r["keep"]
    if raw_gt is not None:
        gt = raw_gt(d["image_id"], with_masks=segm)
        gt_kw = dict(gt_boxes=gt["boxes"], gt_labels=gt["labels"],
                     gt_iscrowd=gt["iscrowd"], gt_areas=gt["areas"])
    else:
        gv = r["batch_gt"]["gt_valid"]
        gt_kw = dict(gt_boxes=r["batch_gt"]["gt_boxes"][gv],
                     gt_labels=r["batch_gt"]["gt_labels"][gv])
    kw = dict(det_boxes=d["boxes"][keep], det_scores=d["scores"][keep],
              det_labels=d["labels"][keep], **gt_kw)
    if segm:
        kw.update(gt_masks=gt["masks"], det_masks=r["rles"],
                  mask_size=gt["mask_size"])
    ev.add_image(d["image_id"], **kw)


@pytest.mark.parametrize("case", ["bbox_raw_gt", "bbox_batch_gt", "segm"])
def test_merges_equal_datr_tpu(case, monkeypatch):
    """Process p holds images 11 + p, 13 + p. Each process's evaluator,
    after the port's merge, gives the stats of one evaluator over all four
    images, and so does datr_tpu's merge run on the same records (its
    process_allgather and process index patched to the same simulated
    processes); atol 1e-12."""
    segm = case == "segm"
    recs = _records(with_raw_gt=case != "bbox_batch_gt")
    raw_gt = None if case == "bbox_batch_gt" else _raw_gt(recs)
    shards = [[11, 13], [12, 14]]
    iou = "segm" if segm else "bbox"
    ref = TEvaluator([1, 2], iou_type=iou)
    for iid in recs:
        _add_local(ref, recs[iid], raw_gt, segm)
    want = ref.summarize()
    assert want[1] > 0

    procs = _Procs()
    monkeypatch.setattr(pdist, "all_gather_numpy", procs.gather)
    monkeypatch.setattr(pdist, "process_index", procs.index)
    monkeypatch.setattr(pdist, "process_count", lambda: WORLD)
    monkeypatch.setattr(multihost_utils, "process_allgather", procs.gather)
    monkeypatch.setattr(jax, "process_index", procs.index)
    monkeypatch.setattr(jax, "process_count", lambda: WORLD)

    def one(evaluator_cls, merge, merge_segm):
        def fn(p):
            ev = evaluator_cls([1, 2], iou_type=iou)
            mine = [recs[i] for i in shards[p]]
            for r in mine:
                _add_local(ev, r, raw_gt, segm)
            if segm:
                merge_segm(ev, [dict(image_id=r["det"]["image_id"],
                                     boxes=r["det"]["boxes"][r["keep"]],
                                     scores=r["det"]["scores"][r["keep"]],
                                     labels=r["det"]["labels"][r["keep"]],
                                     rles=r["rles"]) for r in mine], raw_gt)
            else:
                merge(ev, [r["det"] for r in mine], raw_gt, 6, 3)
            return ev.summarize()
        return procs.run(fn)

    got = one(TEvaluator, tengine.merge_across_processes,
              tengine.merge_segm_across_processes)
    theirs = one(JEvaluator, jengine._merge_across_processes,
                 jengine._merge_segm_across_processes)
    for stats in (*got, *theirs):
        np.testing.assert_allclose(stats, want, rtol=0, atol=1e-12)
