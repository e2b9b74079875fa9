"""The port's data pipeline against datr_tpu's and against Pillow on the CPU.

`datr_torch.data.pil_ops` stands in for the PIL calls of datr_tpu's
pipeline; each op is held pixel-equal (np.array_equal, no tolerance) to the
Pillow it replaces. The transforms, the strong augmentation, the canvas
step, the COCO datasets and the three loaders are held to datr_tpu's:
the same seeds give batches whose every key is np.array_equal, with the
same dtypes. Images come from numpy seeds; the COCO folders are PNGs
written under tmp_path."""

import json
import random

import numpy as np
import pytest
import torch_port_threads  # noqa: F401  (torch threads under xdist)
from PIL import Image, ImageEnhance, ImageFilter

from datr_torch import native as tnative
from datr_torch.data import coco as tcoco
from datr_torch.data import loader as tloader
from datr_torch.data import pil_ops
from datr_torch.data import strong_aug as taug
from datr_torch.data import synthetic as tsynth
from datr_torch.data import transforms as ttf
from datr_tpu import native as jnative
from datr_tpu.data import coco as jcoco
from datr_tpu.data import loader as jloader
from datr_tpu.data import strong_aug as jaug
from datr_tpu.data import synthetic as jsynth
from datr_tpu.data import transforms as jtf

# tests/test_main_cli.py's tiny augmentation scales
AUG = dict(scales=[72, 80], max_size=120, scales2_resize=[64, 72],
           scales2_crop=[48, 72])
CANVAS = (96, 128)


def rgb(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def pil(a):
    return Image.fromarray(a)


def assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ---------------- pil_ops against Pillow ----------------


@pytest.mark.parametrize("src_hw,out_hw", [
    ((37, 53), (41, 97)),      # up x1.1 / x1.8
    ((100, 77), (30, 23)),     # down x0.3
    ((64, 64), (64, 20)),      # width only, the height unchanged
    ((51, 40), (163, 40)),     # height only, up x3.2
    ((33, 71), (10, 227)),     # down x0.3 / up x3.2, odd sizes
    ((7, 9), (3, 2)),
    ((1024, 2048), (720, 1440)),  # Cityscapes to the C2F scale
])
def test_resize_bilinear_equals_pil(src_hw, out_hw):
    a = rgb(sum(src_hw), *src_hw)
    want = np.asarray(pil(a).resize(out_hw[::-1], Image.BILINEAR))
    np.testing.assert_array_equal(
        pil_ops.resize_bilinear(a, out_hw[::-1]), want)


def test_flip_crop_gray_equal_pil():
    a = rgb(1, 30, 41)
    np.testing.assert_array_equal(
        pil_ops.hflip(a), np.asarray(pil(a).transpose(Image.FLIP_LEFT_RIGHT)))
    for box in ((3, 5, 30, 22), (0, 0, 41, 30), (-4, 25, 45, 36)):
        np.testing.assert_array_equal(pil_ops.crop(a, box),
                                      np.asarray(pil(a).crop(box)))
    np.testing.assert_array_equal(pil_ops.to_gray_l(a),
                                  np.asarray(pil(a).convert("L")))


@pytest.mark.parametrize("factor", [0.6, 1.0, 1.4, 2.0])
def test_enhancers_equal_pil(factor):
    """Brightness, Contrast, Color; 2.0 extrapolates (the clipped branch of
    Image.blend)."""
    a = rgb(2, 45, 67)
    for name in ("Brightness", "Contrast", "Color"):
        want = np.asarray(getattr(ImageEnhance, name)(pil(a)).enhance(factor))
        np.testing.assert_array_equal(
            getattr(pil_ops, name.lower())(a, factor), want, err_msg=name)


def test_hsv_round_trip_every_rgb_triple():
    """rgb_to_hsv and hsv_to_rgb over all 2^24 RGB triples in one image,
    equal to convert("HSV") and back, without and with a hue roll (the
    strong augmentation's, a uint8 wrap of H)."""
    v = np.arange(1 << 24, dtype=np.uint32)
    img = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)
    hsv = np.asarray(pil(img).convert("HSV"))
    np.testing.assert_array_equal(pil_ops.rgb_to_hsv(img), hsv)
    for roll in (0, 23):
        h = hsv.copy()
        h[..., 0] += np.uint8(roll)
        want = np.asarray(Image.fromarray(h, "HSV").convert("RGB"))
        np.testing.assert_array_equal(pil_ops.hsv_to_rgb(h), want,
                                      err_msg=str(roll))


@pytest.mark.parametrize("sigma", [0.1, 0.5, 1.0, 2.0])
def test_gaussian_blur_equals_pil(sigma):
    a = rgb(3, 53, 71)
    want = np.asarray(pil(a).filter(ImageFilter.GaussianBlur(radius=sigma)))
    np.testing.assert_array_equal(pil_ops.gaussian_blur(a, sigma), want)


# ---------------- augmentations and the canvas against datr_tpu ----------


def test_strong_augment_equals_datr_tpu():
    """The whole chain from one random.Random each: jitter in a random
    order with hue, grayscale, blur; every seed also leaves both streams at
    the same state."""
    a = rgb(4, 40, 56)
    for seed in range(12):
        r1, r2 = random.Random(seed), random.Random(seed)
        np.testing.assert_array_equal(
            taug.strong_augment(a, r1),
            np.asarray(jaug.strong_augment(pil(a), r2)), err_msg=str(seed))
        assert r1.random() == r2.random()


def test_single_domain_extras_equal_datr_tpu():
    a = rgb(5, 30, 40)
    for f in (0.5, 1.0, 1.37, 2.0):
        np.testing.assert_array_equal(
            taug.adjust_brightness(a, f),
            np.asarray(jaug.adjust_brightness(pil(a), f)))
        np.testing.assert_array_equal(
            taug.adjust_contrast(a, f),
            np.asarray(jaug.adjust_contrast(pil(a), f)))
    for seed in range(4):
        np.testing.assert_array_equal(
            taug.lighting_noise(a, random.Random(seed)),
            np.asarray(jaug.lighting_noise(pil(a), random.Random(seed))))


def test_resize_normalize_pad_bitwise_equals_datr_tpu():
    """The port's float32 canvas against datr_tpu's native kernel (which
    its finalize_example calls): bitwise, scaled and unscaled."""
    for (sh, sw), out, canvas in (((20, 30), (20, 30), (24, 32)),
                                  ((41, 59), (22, 33), (24, 40)),
                                  ((50, 60), (90, 101), (96, 128))):
        a = rgb(sh, sh, sw)
        got = tnative.resize_normalize_pad(a, out, canvas, ttf.IMAGENET_MEAN,
                                           ttf.IMAGENET_STD)
        want = jnative.resize_normalize_pad(a, out, canvas,
                                            jtf.IMAGENET_MEAN,
                                            jtf.IMAGENET_STD)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(60, 90), (150, 100), (200, 300)])
def test_finalize_example_bitwise_equals_datr_tpu(hw):
    """Fitting, too tall and too large for the 96x128 canvas; every key."""
    ds = tsynth.SyntheticDetectionDataset(2, hw, 8, max_objects=6, seed=7)
    for i in range(2):
        img, tgt = ds.load(i)
        got = ttf.finalize_example(img, tgt, CANVAS, 5)
        want = jtf.finalize_example(pil(img), tgt, CANVAS, 5)
        assert_batches_equal([got], [want])
    got = ttf.finalize_example(img, None, CANVAS, 5)
    assert_batches_equal([got], [jtf.finalize_example(pil(img), None,
                                                      CANVAS, 5)])


def test_masks_are_refused(data_root):
    """Instance masks now run through the transforms and the canvas step
    as datr_tpu's do (tests/test_torch_port_masks_data.py holds them
    bitwise over more cases): a flip / resize / crop chain and the stride-4
    targets equal here. What stays refused, in both packages, is the
    training set of a paired DA layout with masks: its pipeline carries
    none."""
    img, tgt = tsynth.SyntheticDetectionDataset(1, (40, 50), 3).load(0)
    m = np.zeros((len(tgt["boxes"]), 40, 50), np.uint8)
    m[:, 5:30, 8:41] = 1
    tgt = dict(tgt, masks=m)
    assert_batches_equal([ttf.finalize_example(img, tgt, CANVAS, 5)],
                         [jtf.finalize_example(pil(img), tgt, CANVAS, 5)])
    got = ttf.DATrainTransform(**AUG)(img, None, tgt, random.Random(0))[2]
    want = jtf.DATrainTransform(**AUG)(pil(img), None, tgt,
                                       random.Random(0))[2]
    np.testing.assert_array_equal(got["masks"], want["masks"])
    for mod in (tcoco, jcoco):
        with pytest.raises(ValueError, match="single-domain"):
            mod.build_dataset("train", "c2f", data_root, return_masks=True)


# ---------------- the loaders against datr_tpu ----------------


@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 1), (1, 0), (1, 1)])
@pytest.mark.parametrize("compute_strong", [True, False])
def test_make_da_loader_equals_datr_tpu(seed, epoch, compute_strong):
    kw = dict(max_boxes=8, seed=seed, epoch=epoch,
              compute_strong=compute_strong, num_threads=2)
    got = tloader.make_da_loader(tsynth.synthetic_da_pair(6, num_classes=4),
                                 2, CANVAS, ttf.DATrainTransform(**AUG), **kw)
    want = jloader.make_da_loader(jsynth.synthetic_da_pair(6, num_classes=4),
                                  2, CANVAS, jtf.DATrainTransform(**AUG),
                                  **kw)
    assert_batches_equal(got, want)


@pytest.mark.parametrize("num_threads", [1, 2, 4])
def test_threaded_loader_raises_a_batch_error_in_its_place(num_threads):
    """A batch whose building raises: the batches before it come in order,
    then its exception reaches the consumer."""
    def make_batch(items):
        if items[0][0] == 3:
            raise OSError("bad image 3")
        return {"idx": np.array([idx for idx, _ in items])}

    it = tloader._threaded_in_order([[i] for i in range(6)], make_batch, 0,
                                    num_threads)
    got = []
    with pytest.raises(OSError, match="bad image 3"):
        for b in it:
            got.append(int(b["idx"][0]))
    assert got == [0, 1, 2]


def _write_coco(root, name, n, seed, size=(70, 90), extras=True):
    """<root>/<name>/{images/*.png, annotations.json}: random boxes of
    categories 1-3, plus a crowd box, a degenerate box and a box past the
    border on every other image."""
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
        for _ in range(3):
            x, y = rng.uniform(0, w - 20), rng.uniform(0, h - 20)
            bw, bh = rng.uniform(5, 20), rng.uniform(5, 20)
            anns.append({"id": len(anns), "image_id": 10 + i,
                         "bbox": [x, y, bw, bh], "area": bw * bh * 0.9,
                         "category_id": int(rng.integers(1, 4))})
        if extras and i % 2 == 0:
            for bbox, crowd in (([5, 5, 30, 20], 1), ([10, 10, 0, 6], 0),
                                ([w - 15, h - 10, 40, 30], 0)):
                anns.append({"id": len(anns), "image_id": 10 + i,
                             "bbox": bbox, "iscrowd": crowd,
                             "category_id": 2})
    (d / "annotations.json").write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": c, "name": str(c)} for c in (1, 2, 3)]}))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    for split, n, seed in (("source", 4, 1), ("target", 5, 2), ("val", 3, 3)):
        _write_coco(root / "c2f", split, n, seed)
    for split, n, seed in (("train", 4, 4), ("val", 3, 5)):
        _write_coco(root / "single", split, n, seed)
    return str(root)


def test_build_dataset_and_eval_annotations_equal_datr_tpu(data_root):
    """Paired and single-domain layouts: the loaded images and targets
    (crowd, degenerate and past-the-border boxes filtered and clamped as
    datr_tpu does) and the raw eval GT (crowd kept, annotation areas)."""
    for name, split in (("c2f", "val"), ("single", "train")):
        t = tcoco.build_dataset(split, name, data_root)
        j = jcoco.build_dataset(split, name, data_root)
        assert len(t) == len(j) and t.category_ids() == j.category_ids()
        for i in range(len(t)):
            (ti, tt), (ji, jt) = t.load(i), j.load(i)
            np.testing.assert_array_equal(ti, np.asarray(ji))
            assert set(tt) == set(jt)
            for k in tt:
                np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
            image_id = tt["image_id"]
            te, je = t.eval_annotations(image_id), j.eval_annotations(
                image_id)
            assert_batches_equal([te], [je])
    paired = tcoco.build_dataset("train", "c2f", data_root)
    assert isinstance(paired, tcoco.DAPairedDataset) and len(paired) == 5
    ann = t.eval_annotations(10)
    assert ann["iscrowd"].any() and len(ann["boxes"]) == 6
    assert len(t.load(0)[1]["boxes"]) == 4  # crowd + degenerate dropped
    for mod in (tcoco, jcoco):  # the layout is read; its files are absent
        with pytest.raises(FileNotFoundError):
            mod.build_dataset("train", "coco_panoptic", data_root)
    got = tcoco.build_dataset("val", "c2f", data_root, return_masks=True)
    want = jcoco.build_dataset("val", "c2f", data_root, return_masks=True)
    np.testing.assert_array_equal(got.load(0)[1]["masks"],
                                  want.load(0)[1]["masks"])


def test_o365_shards_equal_datr_tpu(tmp_path):
    """The o365 layout: two annotation shards under one image folder, one
    dataset (ConcatDetectionDataset)."""
    d = tmp_path / "o365" / "val"
    _write_coco(tmp_path / "o365", "val", 4, 6, extras=False)
    ann = json.loads((d / "annotations.json").read_text())
    for k, ids in ((0, (10, 11)), (1, (12, 13))):
        part = dict(ann, images=[im for im in ann["images"]
                                 if im["id"] in ids],
                    annotations=[a for a in ann["annotations"]
                                 if a["image_id"] in ids])
        (d / f"annotations_{k}.json").write_text(json.dumps(part))
    (d / "annotations.json").unlink()
    t = tcoco.build_dataset("val", "o365", str(tmp_path))
    j = jcoco.build_dataset("val", "o365", str(tmp_path))
    assert isinstance(t, tcoco.ConcatDetectionDataset) and len(t) == 4
    for i in range(4):
        (ti, tt), (ji, jt) = t.load(i), j.load(i)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_array_equal(tt["boxes"], jt["boxes"])
        assert_batches_equal([t.eval_annotations(tt["image_id"])],
                             [j.eval_annotations(jt["image_id"])])


def test_make_da_loader_on_coco_files_equals_datr_tpu(data_root):
    kw = dict(max_boxes=8, seed=3, num_threads=2)
    got = tloader.make_da_loader(
        tcoco.build_dataset("train", "c2f", data_root), 2, CANVAS,
        ttf.DATrainTransform(**AUG), **kw)
    want = jloader.make_da_loader(
        jcoco.build_dataset("train", "c2f", data_root), 2, CANVAS,
        jtf.DATrainTransform(**AUG), **kw)
    assert_batches_equal(got, want)


@pytest.mark.parametrize("strong_aug", [False, True])
def test_make_single_loader_equals_datr_tpu(data_root, strong_aug):
    kw = dict(max_boxes=8, seed=5, epoch=1, num_threads=2)
    got = tloader.make_single_loader(
        tcoco.build_dataset("train", "single", data_root), 2, CANVAS,
        ttf.SingleDomainTrainTransform(**AUG, strong_aug=strong_aug), **kw)
    want = jloader.make_single_loader(
        jcoco.build_dataset("train", "single", data_root), 2, CANVAS,
        jtf.SingleDomainTrainTransform(**AUG, strong_aug=strong_aug), **kw)
    assert_batches_equal(got, want)


@pytest.mark.parametrize("num_threads", [1, 3])
def test_eval_loader_equals_datr_tpu(data_root, num_threads):
    """3 images in batches of 2: the tail batch padded with the last
    image, marked in batch_valid."""
    got = tloader.make_eval_loader(
        tcoco.build_dataset("val", "c2f", data_root), 2, CANVAS,
        ttf.EvalTransform(80, 120), 8, num_threads=num_threads)
    want = jloader.make_eval_loader(
        jcoco.build_dataset("val", "c2f", data_root), 2, CANVAS,
        jtf.EvalTransform(80, 120), 8, num_threads=num_threads)
    assert_batches_equal(got, want)
    assert list(got)[-1]["batch_valid"].tolist() == [True, False]
    assert got.dataset.eval_annotations is not None


@pytest.mark.parametrize("index,count", [(0, 2), (1, 2), (2, 3)])
def test_loader_shards_equal_datr_tpu(data_root, index, count):
    """Process `index` of `count`: the paired, single-domain and eval
    loaders (EvalLoader itself and make_eval_loader) take datr_tpu's share
    of the batches and images, np.array_equal, with the eval batch count
    rounded up alike on every process."""
    shard = dict(process_index=index, process_count=count)
    kw = dict(max_boxes=8, seed=2, epoch=1, num_threads=2, **shard)
    assert_batches_equal(
        tloader.make_da_loader(tsynth.synthetic_da_pair(6, num_classes=4), 1,
                               CANVAS, ttf.DATrainTransform(**AUG), **kw),
        jloader.make_da_loader(jsynth.synthetic_da_pair(6, num_classes=4), 1,
                               CANVAS, jtf.DATrainTransform(**AUG), **kw))
    assert_batches_equal(
        tloader.make_single_loader(
            tcoco.build_dataset("train", "single", data_root), 1, CANVAS,
            ttf.SingleDomainTrainTransform(**AUG), **kw),
        jloader.make_single_loader(
            jcoco.build_dataset("train", "single", data_root), 1, CANVAS,
            jtf.SingleDomainTrainTransform(**AUG), **kw))
    eval_kw = dict(num_threads=1, **shard)
    args = (2, CANVAS)
    got = tloader.EvalLoader(tcoco.build_dataset("val", "c2f", data_root),
                             *args, ttf.EvalTransform(80, 120), 8, **eval_kw)
    want = jloader.EvalLoader(jcoco.build_dataset("val", "c2f", data_root),
                              *args, jtf.EvalTransform(80, 120), 8, **eval_kw)
    assert got.n_batches == want.n_batches == 1
    assert_batches_equal(got, want)
    assert_batches_equal(
        tloader.make_eval_loader(
            tcoco.build_dataset("val", "c2f", data_root), *args,
            ttf.EvalTransform(80, 120), 8, **eval_kw),
        jloader.make_eval_loader(
            jcoco.build_dataset("val", "c2f", data_root), *args,
            jtf.EvalTransform(80, 120), 8, **eval_kw))


def test_open_rgb_without_pil_raises(data_root, tmp_path, monkeypatch):
    """Without PIL the port still reads the PNG folders (its own decoder,
    the images equal to datr_tpu's through PIL); a file that is neither
    JPEG nor PNG (BMP here) needs PIL and raises, naming what the port
    decodes without it."""
    ds = tcoco.build_dataset("val", "c2f", data_root)
    want = np.asarray(jcoco.build_dataset("val", "c2f", data_root).load(0)[0])
    bmp = tmp_path / "frame.bmp"
    pil(rgb(9, 20, 30)).save(bmp)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    np.testing.assert_array_equal(ds.load(0)[0], want)
    with pytest.raises(ImportError, match="needs PIL.*JPEG and PNG without it"):
        tcoco.open_rgb(str(bmp))
