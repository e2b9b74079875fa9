"""The port's instance-mask data, evaluation and serving paths against
datr_tpu's (and Pillow) on the CPU: the RLE utilities, decode_segmentation
(polygons filled as Pillow's ImageDraw.polygon fills them), the transforms
and the single-domain loader with masks, the segm evaluator, det_mask_rles,
evaluate(segm=True) on a COCO tree under tmp_path, the server's mask
answers (InferenceServer and serve_http), and the COCO-panoptic dataset,
postprocess and PQ evaluator.

Tolerances: bitwise (np.array_equal) for the RLE functions, the decoded
masks, the polygon fill against Pillow, the transforms' and the loader's
batches, det_mask_rles on the same logits, the server's RLEs against
det_mask_rles of eval_step, the panoptic items, id maps and PQ; the segm
stats within 1e-6. The models are tests/test_torch_port_masks.py's tiny
DINO with masks (hidden 128, 8 heads, a ResNet of one block per stage)
with seeded parameters over `jax.eval_shape`'s tree."""

import json
import os
import random
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (torch threads under xdist)
from PIL import Image, ImageDraw

from datr_torch import engine as tengine
from datr_torch import serve as tserve
from datr_torch.convert import load_flax_params
from datr_torch.data import coco as tcoco
from datr_torch.data import loader as tloader
from datr_torch.data import panoptic as tpan
from datr_torch.data import pil_ops
from datr_torch.data import transforms as ttf
from datr_torch.eval import coco_eval as tce
from datr_torch.eval import panoptic_eval as tpe
from datr_torch.models import dino as tdino
from datr_torch.models import segmentation as tseg
from datr_torch.train.steps import eval_step
from datr_torch.utils import rle as trle
from datr_tpu import engine as jengine
from datr_tpu.data import coco as jcoco
from datr_tpu.data import loader as jloader
from datr_tpu.data import panoptic as jpan
from datr_tpu.data import transforms as jtf
from datr_tpu.eval import coco_eval as jce
from datr_tpu.eval import panoptic_eval as jpe
from datr_tpu.models import dino as jdino
from datr_tpu.models import segmentation as jseg
from datr_tpu.utils import rle as jrle

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_bf16 import seeded_params  # noqa: E402
from test_torch_port_data import AUG, assert_batches_equal, rgb  # noqa: E402
from test_torch_port_masks import KW, STAGES  # noqa: E402

CANVAS = (96, 128)


# ---------------- RLE ----------------


def _masks(seed, n=6, h=23, w=31):
    rng = np.random.default_rng(seed)
    m = rng.random((n, h, w)) < rng.uniform(0.05, 0.9, (n, 1, 1))
    m[0] = True  # full; the first pixel set
    m[1] = False  # empty
    return m.astype(np.uint8)


def test_rle_functions_bitwise():
    """encode / decode / area, the string coding both ways, masks_to_rles
    and the crowd-aware mask IoU: every output equal to datr_tpu's."""
    m = _masks(0)
    crowd = np.array([False, True, False, False, True, False])
    for a, b in zip(trle.masks_to_rles(m), jrle.masks_to_rles(m)):
        np.testing.assert_array_equal(a, b)
    for x in m:
        c = trle.encode_mask(x)
        np.testing.assert_array_equal(c, jrle.encode_mask(x))
        assert c.dtype == jrle.encode_mask(x).dtype
        np.testing.assert_array_equal(trle.decode_counts(c, *x.shape),
                                      jrle.decode_counts(c, *x.shape))
        assert trle.area_of_counts(c) == jrle.area_of_counts(c) == x.sum()
        s = trle.string_from_counts(c)
        assert s == jrle.string_from_counts(c)
        assert trle.counts_from_string(s) == jrle.counts_from_string(s)
        assert trle.counts_from_string(s.encode()) == list(c)
    d, g = trle.masks_to_rles(_masks(1)), trle.masks_to_rles(m)
    np.testing.assert_array_equal(trle.mask_iou(d, g, crowd, 23, 31),
                                  jrle.mask_iou(d, g, crowd, 23, 31))
    assert trle.mask_iou([], g, crowd, 23, 31).shape == (0, 6)


# ---------------- decode_segmentation and the polygon fill ----------------


def _polygon(rng, h, w):
    """A polygon of one of six kinds: float star, random (self-crossing,
    partly outside), integer, 4-pixel grid, half-integer, on the border."""
    kind, n = int(rng.integers(6)), int(rng.integers(3, 12))
    if kind == 0:
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(2, max(h, w) / 2, n)
        pts = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1)
    elif kind == 1:
        pts = np.stack([rng.uniform(-5, w + 5, n),
                        rng.uniform(-5, h + 5, n)], 1)
    elif kind == 2:
        pts = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], 1)
    elif kind == 3:
        pts = 4 * np.stack([rng.integers(0, w // 4, n),
                            rng.integers(0, h // 4, n)], 1)
    elif kind == 4:
        pts = np.stack([rng.integers(0, 2 * w, n),
                        rng.integers(0, 2 * h, n)], 1) / 2
    else:
        pts = np.stack([rng.choice([0, w - 1, w, rng.uniform(0, w)], n),
                        rng.choice([0, h - 1, h, rng.uniform(0, h)], n)], 1)
    return [float(v) for v in np.asarray(pts, np.float64).reshape(-1)]


def _pillow_fill(poly, h, w):
    im = Image.new("L", (w, h), 0)
    ImageDraw.Draw(im).polygon(poly, fill=1)
    return np.asarray(im, np.uint8)


@pytest.mark.parametrize("seed", range(4))
def test_polygon_fill_equals_pillow(seed):
    """400 seeded polygons per seed on 5..90-pixel images: float vertices,
    concave and self-crossing ones, collinear spikes, vertices on and past
    the border; every pixel as Pillow fills it. Then small integer
    polygons of 3-4 vertices, where the corner rules act most."""
    rng = np.random.default_rng(seed)
    for _ in range(400):
        h, w = int(rng.integers(5, 90)), int(rng.integers(5, 90))
        poly = _polygon(rng, h, w)
        np.testing.assert_array_equal(pil_ops.polygon_fill(poly, h, w),
                                      _pillow_fill(poly, h, w), err_msg=poly)
    for _ in range(400):
        h, w = int(rng.integers(4, 10)), int(rng.integers(4, 10))
        n = int(rng.integers(3, 5))
        poly = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)],
                        1).reshape(-1).astype(float).tolist()
        np.testing.assert_array_equal(pil_ops.polygon_fill(poly, h, w),
                                      _pillow_fill(poly, h, w), err_msg=poly)


def test_decode_segmentation_equals_datr_tpu():
    """Polygon lists (several polygons, a degenerate one of fewer than 6
    coordinates), compressed and uncompressed RLE: the same uint8 mask;
    an RLE of another size raises in both."""
    rng = np.random.default_rng(9)
    h, w = 37, 45
    m = _masks(2, 3, h, w)[2]
    segs = [[_polygon(rng, h, w) for _ in range(k)] for k in (1, 2, 3)]
    segs += [[[1.0, 2.0, 30.0, 4.0]], [[3.0, 3.0, 20.0, 3.5, 9.0, 30.0],
                                       [1.0, 1.0]],
             {"size": [h, w], "counts": jrle.encode_mask(m).tolist()},
             {"size": [h, w],
              "counts": jrle.string_from_counts(jrle.encode_mask(m))}]
    for seg in segs:
        got = tcoco.decode_segmentation(seg, h, w)
        want = jcoco.decode_segmentation(seg, h, w)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    bad = {"size": [h + 1, w], "counts": [0, 5]}
    for mod in (tcoco, jcoco):
        with pytest.raises(ValueError, match="RLE size"):
            mod.decode_segmentation(bad, h, w)


# ---------------- transforms and loader ----------------


def _target(seed, h, w, n=4):
    rng = np.random.default_rng(seed)
    x0, y0 = rng.uniform(0, w - 10, n), rng.uniform(0, h - 10, n)
    b = np.stack([x0, y0, x0 + rng.uniform(4, 30, n),
                  y0 + rng.uniform(4, 30, n)], 1).clip(0, [w, h, w, h])
    return {"boxes": b.astype(np.float32),
            "labels": rng.integers(1, 4, n).astype(np.int64),
            "masks": (rng.random((n, h, w)) < 0.4).astype(np.uint8),
            "image_id": 3, "orig_size": np.array([h, w]),
            "size": np.array([h, w])}


@pytest.mark.parametrize("seed", range(6))
def test_transforms_with_masks_equal_datr_tpu(seed):
    """DATrainTransform (flip, resize, crop, resize), the single-domain
    and eval transforms, then finalize_example (stride 4 soft f16 targets,
    an image past the canvas rescaled; stride 1 binary): every key
    np.array_equal with datr_tpu's, masks included."""
    h, w = 70 + 7 * seed, 90 - 5 * seed
    img, tgt = rgb(seed, h, w), _target(seed, h, w)
    for tf_t, tf_j in (
            (ttf.DATrainTransform(**AUG), jtf.DATrainTransform(**AUG)),
            (ttf.SingleDomainTrainTransform(**AUG),
             jtf.SingleDomainTrainTransform(**AUG))):
        args = (img, None, tgt) if isinstance(tf_t, ttf.DATrainTransform) \
            else (img, tgt)
        jargs = ((Image.fromarray(img), None, tgt) if len(args) == 3
                 else (Image.fromarray(img), tgt))
        got = tf_t(*args, random.Random(seed))
        want = tf_j(*jargs, random.Random(seed))
        gt_, wt_ = got[-1], want[-1]
        assert set(gt_) == set(wt_)
        for k in wt_:
            np.testing.assert_array_equal(gt_[k], wt_[k], err_msg=k)
        gi, wi = got[0], np.asarray(want[0])
        np.testing.assert_array_equal(gi, wi)
        for stride in (4, 1):
            assert_batches_equal(
                [ttf.finalize_example(gi, gt_, CANVAS, 5, stride)],
                [jtf.finalize_example(want[0], wt_, CANVAS, 5, stride)])
    big = rgb(seed, 140, 150), _target(seed + 1, 140, 150, n=7)
    assert_batches_equal([ttf.finalize_example(*big, CANVAS, 5)],
                         [jtf.finalize_example(Image.fromarray(big[0]), big[1],
                                               CANVAS, 5)])
    ev_t = ttf.EvalTransform(80, 120)(img, tgt)
    ev_j = jtf.EvalTransform(80, 120)(Image.fromarray(img), tgt)
    np.testing.assert_array_equal(ev_t[1]["masks"], ev_j[1]["masks"])


def _write_masks_coco(root, name, n, seed, size=(70, 90)):
    """<root>/<name>/{images/*.png, annotations.json}: 3 objects per image
    with polygon, uncompressed-RLE and compressed-RLE segmentations, a
    crowd RLE, a degenerate box."""
    d = root / name
    (d / "images").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    images, anns = [], []
    for i in range(n):
        h, w = size[0] + 4 * i, size[1] - 3 * i
        Image.fromarray(rgb(seed * 100 + i, h, w)).save(
            d / "images" / f"{i}.png")
        images.append({"id": 10 + i, "file_name": f"{i}.png", "height": h,
                       "width": w})
        for j in range(4):
            x, y = rng.uniform(0, w - 25), rng.uniform(0, h - 25)
            bw, bh = rng.uniform(8, 25), rng.uniform(8, 25)
            m = np.zeros((h, w), np.uint8)
            m[int(y):int(y + bh), int(x):int(x + bw)] = rng.random(
                (int(y + bh) - int(y), int(x + bw) - int(x))) < 0.7
            counts = jrle.encode_mask(m)
            seg = ([[x, y, x + bw, y + 0.3 * bh, x + 0.6 * bw, y + bh]]
                   if j == 0 else {"size": [h, w], "counts": counts.tolist()}
                   if j == 1 else {"size": [h, w], "counts":
                                   jrle.string_from_counts(counts)})
            anns.append({"id": len(anns), "image_id": 10 + i,
                         "bbox": [x, y, bw, bh], "area": float(m.sum()),
                         "category_id": 1 + j % 3, "segmentation": seg,
                         "iscrowd": int(j == 3)})
        anns.append({"id": len(anns), "image_id": 10 + i,
                     "bbox": [3, 3, 0, 5], "category_id": 2,
                     "segmentation": [[3, 3, 3, 8, 3, 5]]})
    (d / "annotations.json").write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": c, "name": str(c)} for c in (1, 2, 3)]}))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_masks")
    for split, n, seed in (("train", 4, 4), ("val", 3, 5)):
        _write_masks_coco(root / "single", split, n, seed)
    for split, n, seed in (("source", 2, 1), ("target", 2, 2),
                           ("val", 2, 3)):
        _write_masks_coco(root / "c2f", split, n, seed)
    return str(root)


def test_datasets_with_masks_equal_datr_tpu(data_root):
    """return_masks: each item (masks aligned with the kept boxes) and the
    raw eval GT with mask RLEs equal datr_tpu's; a paired DA layout with
    return_masks raises for training in both; coco_panoptic reads its
    layout (absent here: FileNotFoundError in both)."""
    for split in ("train", "val"):
        t = tcoco.build_dataset(split, "single", data_root, return_masks=True)
        j = jcoco.build_dataset(split, "single", data_root,
                                return_masks=True)
        for i in range(len(t)):
            (ti, tt), (ji, jt) = t.load(i), j.load(i)
            np.testing.assert_array_equal(ti, np.asarray(ji))
            assert set(tt) == set(jt) and len(tt["masks"]) == 3
            for k in tt:
                np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
            for wm in (False, True):
                te = t.eval_annotations(tt["image_id"], with_masks=wm)
                je = j.eval_annotations(tt["image_id"], with_masks=wm)
                assert set(te) == set(je)
                for k in je:
                    if k == "masks":
                        for a, b in zip(te[k], je[k]):
                            np.testing.assert_array_equal(a, b)
                    else:
                        np.testing.assert_array_equal(te[k], je[k])
    for mod in (tcoco, jcoco):
        with pytest.raises(ValueError, match="single-domain"):
            mod.build_dataset("train", "c2f", data_root, return_masks=True)
        with pytest.raises(FileNotFoundError):
            mod.build_dataset("val", "coco_panoptic", data_root)


def test_single_loader_with_masks_equals_datr_tpu(data_root):
    """make_single_loader over the masks tree: every key np.array_equal,
    the [b, max_boxes, 24, 32] f16 mask targets included."""
    kw = dict(max_boxes=6, seed=3, epoch=1, num_threads=2)
    got = list(tloader.make_single_loader(
        tcoco.build_dataset("train", "single", data_root, return_masks=True),
        2, CANVAS, ttf.SingleDomainTrainTransform(**AUG), **kw))
    want = jloader.make_single_loader(
        jcoco.build_dataset("train", "single", data_root, return_masks=True),
        2, CANVAS, jtf.SingleDomainTrainTransform(**AUG), **kw)
    assert_batches_equal(got, want)
    assert got[0]["masks"].shape == (2, 6, 24, 32)
    assert got[0]["masks"].dtype == np.float16 and got[0]["masks"].any()


# ---------------- segm evaluation ----------------


def test_segm_evaluator_equals_datr_tpu():
    """CocoEvaluator('segm') over 5 images of random masks (binary arrays
    and RLE counts, crowd GT): the 12 stats equal datr_tpu's."""
    rng = np.random.default_rng(4)
    ev_t = tce.CocoEvaluator([1, 2, 3], iou_type="segm")
    ev_j = jce.CocoEvaluator([1, 2, 3], iou_type="segm")
    for img in range(5):
        gm = _masks(10 + img, 4, 30, 40)[2:]
        dm = np.concatenate([gm, _masks(20 + img, 3, 30, 40)[2:]])
        dm[0, :5] ^= 1
        kw = dict(gt_boxes=rng.uniform(0, 30, (2, 4)),
                  gt_labels=rng.integers(1, 4, 2),
                  det_boxes=rng.uniform(0, 30, (3, 4)),
                  det_scores=rng.random(3), det_labels=rng.integers(1, 4, 3),
                  gt_iscrowd=np.array([img == 2, False]))
        kw["det_labels"][:2] = kw["gt_labels"]
        if img % 2:
            kw.update(gt_masks=jrle.masks_to_rles(gm),
                      det_masks=jrle.masks_to_rles(dm), mask_size=(30, 40))
        else:
            kw.update(gt_masks=gm, det_masks=dm)
        ev_t.add_image(img, **kw)
        ev_j.add_image(img, **kw)
    want = ev_j.summarize()
    np.testing.assert_array_equal(ev_t.summarize(), want)
    assert want[0] > 0


def test_det_mask_rles_bitwise():
    """The host finish of the same f16-rounded logits: canvas upsample,
    threshold, real-region crop, nearest resize to the original size."""
    rng = np.random.default_rng(6)
    logits = (3 * rng.standard_normal((40, 24, 32))).astype(np.float16)
    for real, orig in (((96, 128), (96, 128)), ((80, 101), (160, 203)),
                       ((96, 90), (50, 47))):
        got = tseg.det_mask_rles(logits.astype(np.float32), CANVAS, real,
                                 orig)
        want = jseg.det_mask_rles(logits.astype(np.float32), CANVAS, real,
                                  orig)
        assert len(got) == len(want) == 40
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_postprocess_segm_equals_datr_tpu():
    """PostProcessSegm: bilinear upsample to the batch's largest size,
    sigmoid > 0.5, each image's region, nearest resize to its original
    size; uint8 masks equal datr_tpu's."""
    rng = np.random.default_rng(8)
    logits = (2 * rng.standard_normal((2, 5, 12, 16))).astype(np.float32)
    orig = np.array([[50, 61], [37, 80]])
    proc = np.array([[48, 60], [40, 64]])
    got = tseg.postprocess_segm([{}, {}], torch.from_numpy(logits), orig,
                                proc)
    want = jseg.postprocess_segm([{}, {}], jnp.asarray(logits), orig, proc)
    for g, w in zip(got, want):
        assert g["masks"].dtype == w["masks"].dtype == np.uint8
        np.testing.assert_array_equal(g["masks"], w["masks"])


@pytest.fixture(scope="module")
def models():
    """tests/test_torch_port_masks.py's tiny model (eval tree, seeded) on
    both sides."""
    mp = pytest.MonkeyPatch()
    mp.setitem(jdino.RESNET_STAGES, "resnet50", STAGES)
    mp.setitem(tdino.RESNET_STAGES, "resnet50", STAGES)
    jm = jdino.DINO(**KW, with_masks=True, use_remat=False)
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, *CANVAS, 3)), jnp.zeros((1, *CANVAS), bool)),
        jax.random.PRNGKey(0))
    params = {"params": seeded_params(shapes["params"], seed=3)}
    tm = tdino.DINO(**KW, with_masks=True, mask_query_chunk=10)
    load_flax_params(tm, params)
    yield jm, params, tm.eval()
    mp.undo()


def test_evaluate_segm_equals_datr_tpu(models, tmp_path):
    """evaluate(segm=True) over a COCO tree whose GT masks are the port's
    own detection masks (a seeded model finds nothing painted): both
    packages' loaders, models and evaluators; coco_eval_masks within 1e-6
    and coco_eval_bbox within 1e-3 of datr_tpu's, mask AP above 0."""
    jm, params, tm = models
    _write_masks_coco(tmp_path / "single", "val", 3, 8)
    ds = tcoco.build_dataset("val", "single", str(tmp_path))
    tf = ttf.EvalTransform(80, 120)
    ann_path = tmp_path / "single" / "val" / "annotations.json"
    ann = json.loads(ann_path.read_text())
    ann["annotations"] = []
    for b in tloader.make_eval_loader(ds, 1, CANVAS, tf, 4, num_threads=1):
        res = eval_step(tm, {k: torch.from_numpy(v) for k, v in b.items()},
                        num_select=3, with_masks=True)
        oh, ow = (int(v) for v in b["orig_sizes"][0])
        rles = tseg.det_mask_rles(res["mask_logits"][0].float().numpy(),
                                  CANVAS, tuple(b["real_sizes"][0]),
                                  (oh, ow))
        for k, (box, lab, c) in enumerate(zip(
                res["boxes"][0].tolist(), res["labels"][0].tolist(), rles)):
            x0, y0, x1, y1 = box
            ann["annotations"].append({
                "id": len(ann["annotations"]),
                "image_id": int(b["image_ids"][0]),
                "bbox": [x0, y0, x1 - x0, y1 - y0], "category_id": lab,
                "area": float(trle.area_of_counts(c)),
                "segmentation": {"size": [oh, ow], "counts": c.tolist()}})
    ann["categories"] = [{"id": c} for c in range(K_CLASSES)]
    ann_path.write_text(json.dumps(ann))
    cats = list(range(K_CLASSES))
    t_ds = tcoco.build_dataset("val", "single", str(tmp_path))
    j_ds = jcoco.build_dataset("val", "single", str(tmp_path))
    got = tengine.evaluate(tm, tloader.make_eval_loader(
        t_ds, 2, CANVAS, tf, 4, num_threads=1), cats, num_select=20,
        segm=True)
    want = jengine.evaluate(params, jm, jloader.make_eval_loader(
        j_ds, 2, CANVAS, jtf.EvalTransform(80, 120), 4, num_threads=1),
        cats, num_select=20, segm=True)
    np.testing.assert_allclose(got["coco_eval_masks"],
                               want["coco_eval_masks"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["coco_eval_bbox"],
                               want["coco_eval_bbox"], rtol=0, atol=1e-3)
    assert got["coco_eval_masks"][0] > 0


K_CLASSES = KW["num_classes"]


# ---------------- serving ----------------


def test_server_mask_answers(models):
    """InferenceServer(mask_top_k=4) on two frames: each answer's masks are
    det_mask_rles of eval_step's f16 logits for the same detections (None
    past the top 4), at the request's original size; serve_http sends them
    as uncompressed RLEs."""
    from datr_torch.data import png

    _, _, tm = models
    frames = [rgb(40 + i, 150 + 10 * i, 190 - 20 * i) for i in range(2)]
    kw = dict(canvas_hw=CANVAS, batch_size=2, num_select=8,
              score_threshold=0.0, resize_short=80, resize_max=120,
              batch_timeout_s=0.05)
    with tserve.InferenceServer(tm, device="cpu", mask_top_k=4,
                                **kw) as srv:
        answers = [srv.detect(f) for f in frames]
        httpd = tserve.serve_http(srv, port=0, start=False)
        import threading

        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            url = f"http://127.0.0.1:{httpd.server_address[1]}/detect"
            body = png.encode_png(frames[0])
            req = urllib.request.Request(url, data=body, method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                payload = json.loads(r.read())
        finally:
            httpd.shutdown()
            httpd.server_close()
    for f, a in zip(frames, answers):
        h0, w0 = f.shape[:2]
        img, real = srv._preprocess(f)
        # the server's batch: this request, then an empty (all-pad) slot
        wire = np.stack([img, np.zeros_like(img)])
        x, pm = tserve.wire_decode(torch.from_numpy(wire),
                                   torch.tensor([real, (0, 0)]), CANVAS,
                                   "u8")
        res = eval_step(tm, {"images": x, "pad_mask": pm,
                             "orig_sizes": torch.ones(2, 2)},
                        num_select=8, with_masks=True)
        logits = res["mask_logits"][0].float().numpy()
        want = tseg.det_mask_rles(logits[:4], CANVAS, real, (h0, w0))
        assert len(a["masks"]) == 8
        for k, m in enumerate(a["masks"]):
            if k < 4:
                np.testing.assert_array_equal(m, want[k])
            else:
                assert m is None
    assert len(payload["masks"]) == 8 and payload["masks"][5] is None
    for m, want in zip(payload["masks"][:4], answers[0]["masks"][:4]):
        assert m["size"] == list(frames[0].shape[:2])
        assert m["counts"] == want.tolist()


# ---------------- COCO panoptic ----------------


def _write_panoptic(root, n=2, hw=(40, 52)):
    """<root>/coco/{val2017/*.jpg, panoptic/panoptic_val2017/*.png,
    panoptic/annotations/panoptic_val2017.json}: id maps of 4 segments
    (one crowd, one absent from the map)."""
    base = root / "coco"
    imgs = base / "val2017"
    maps = base / "panoptic" / "panoptic_val2017"
    for d in (imgs, maps, base / "panoptic" / "annotations"):
        d.mkdir(parents=True)
    rng = np.random.default_rng(12)
    images, anns = [], []
    for i in range(n):
        h, w = hw
        Image.fromarray(rgb(60 + i, h, w)).save(imgs / f"{i:03d}.jpg")
        ids = np.zeros((h, w), np.int64)
        for seg_id in (1001, 2002 + i, 65793):
            y, x = rng.integers(0, h - 12), rng.integers(0, w - 12)
            dy, dx = int(rng.integers(6, 20)), int(rng.integers(6, 24))
            ids[y:y + dy, x:x + dx] = seg_id
        rgbmap = np.stack([ids % 256, ids // 256 % 256, ids // 65536],
                          -1).astype(np.uint8)
        Image.fromarray(rgbmap).save(maps / f"{i:03d}.png")
        images.append({"id": 7 + i, "file_name": f"{i:03d}.jpg",
                       "height": h, "width": w})
        anns.append({"image_id": 7 + i, "file_name": f"{i:03d}.png",
                     "segments_info": [
                         {"id": 1001, "category_id": 1, "iscrowd": 0},
                         {"id": 2002 + i, "category_id": 2, "iscrowd": 0},
                         {"id": 65793, "category_id": 3, "iscrowd": 1},
                         {"id": 4242, "category_id": 1, "iscrowd": 0}]})
    (base / "panoptic" / "annotations" / "panoptic_val2017.json").write_text(
        json.dumps({"images": images, "annotations": anns,
                    "categories": [{"id": c, "isthing": int(c != 3)}
                                   for c in (1, 2, 3)]}))


def test_coco_panoptic_equals_datr_tpu(tmp_path):
    """build_dataset('coco_panoptic'): items with and without masks and the
    raw eval GT with masks equal datr_tpu's; rgb2id and masks_to_boxes
    too."""
    _write_panoptic(tmp_path)
    for masks in (False, True):
        t = tcoco.build_dataset("val", "coco_panoptic", str(tmp_path),
                                return_masks=masks)
        j = jcoco.build_dataset("val", "coco_panoptic", str(tmp_path),
                                return_masks=masks)
        assert isinstance(t, tpan.CocoPanopticDataset)
        assert len(t) == len(j) == 2 and t.category_ids() == j.category_ids()
        for i in range(len(t)):
            (ti, tt), (ji, jt) = t.load(i), j.load(i)
            np.testing.assert_array_equal(ti, np.asarray(ji))
            assert set(tt) == set(jt)
            for k in tt:
                np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
            te = t.eval_annotations(tt["image_id"], with_masks=True)
            je = j.eval_annotations(jt["image_id"], with_masks=True)
            assert set(te) == set(je) and te["mask_size"] == je["mask_size"]
            for a, b in zip(te["masks"], je["masks"]):
                np.testing.assert_array_equal(a, b)
            for k in ("boxes", "labels", "iscrowd", "areas"):
                np.testing.assert_array_equal(te[k], je[k])
    c = rgb(3, 9, 11)
    np.testing.assert_array_equal(tpan.rgb2id(c), jpan.rgb2id(c))
    m = _masks(5, 4, 9, 11).astype(bool)
    np.testing.assert_array_equal(tpan.masks_to_boxes(m),
                                  jpan.masks_to_boxes(m))


@pytest.mark.parametrize("seed", range(3))
def test_postprocess_panoptic_and_pq_equal_datr_tpu(seed):
    """postprocess_panoptic of seeded logits and masks (things and a stuff
    class whose segments merge, tiny segments dropped, a target size
    apart from the processed one): the id map and segments equal; the PQ
    evaluator over its id maps against shifted GT equals datr_tpu's."""
    rng = np.random.default_rng(seed)
    q, k = 10, 5
    logits = rng.standard_normal((q, k)).astype(np.float32) * 3
    logits[:6, rng.integers(0, k - 1, 6)] += 8
    pmasks = (4 * rng.standard_normal((q, 12, 16))).astype(np.float32)
    thing = {0: True, 1: True, 2: False, 3: False}
    kw = dict(processed_size=(24, 32), target_size=(20, 27),
              threshold=0.6)
    got = tseg.postprocess_panoptic(logits, pmasks, thing, **kw)
    want = jseg.postprocess_panoptic(logits, pmasks, thing, **kw)
    np.testing.assert_array_equal(got["id_map"], want["id_map"])
    assert got["segments_info"] == want["segments_info"]
    ev_t, ev_j = tpe.PanopticEvaluator(), jpe.PanopticEvaluator()
    pred_ids = want["id_map"] + 1
    cats = {s["id"] + 1: s["category_id"] for s in want["segments_info"]}
    gt_ids = np.roll(pred_ids, (1, 2), (0, 1))
    gt_ids[:2] = 0
    crowd = {min(cats, default=1): True}
    for ev in (ev_t, ev_j):
        ev.add_image(pred_ids, cats, gt_ids, cats, crowd)
        ev.add_image(pred_ids, cats, pred_ids, cats)
    a, b = ev_t.summarize(), ev_j.summarize()
    assert a == b and b["n"] > 0
