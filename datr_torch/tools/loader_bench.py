"""Host data-pipeline throughput (port of tools/loader_bench.py).

    python -m datr_torch.tools.loader_bench [--images 32] [--threads 4]
        [--batch 2] [--hw 1024 2048] [--device cpu]

Writes `--images` seeded synthetic frames of `--hw` (Cityscapes' 1024x2048
by default) per domain to a temporary COCO tree, as JPEG at quality 90
through libjpeg (`native.encode_jpeg_rgb`) or, where the machine has no
libjpeg, as PNG (`data/png.encode_png`), so that the decode from disk is on
the measured path as it is in training. Then drains three loaders over it,
each batch moved to `--device` (default: the CUDA card) through pinned
memory as the training loop moves it (`data.loader.to_device`):
  da_train_strong  make_da_loader with the strong views (self-training
                   epochs);
  da_train_weak    make_da_loader, compute_strong=False (burn-in epochs);
  eval             make_eval_loader at the eval resolution.
The transforms are the C2F configs' (train scales 480-800 capped at 1333,
canvas 800x1344). Prints one JSON line per mode: {"mode", "threads",
"img_per_s", "ms_per_batch", "format", "device"}; each domain's image
counts (a DA batch holds `--batch` source and `--batch` target images).
The host's numbers, with the card only as the batches' destination.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from .. import resolve_device
from ..data.coco import CocoDetectionDataset, DAPairedDataset
from ..data.loader import make_da_loader, make_eval_loader, to_device
from ..data.synthetic import SyntheticDetectionDataset
from ..data.transforms import DATrainTransform, EvalTransform

# the C2F geometry (configs/DA/Cityscapes2FoggyCityscapes/*), as
# tools/loader_bench.py takes it
SCALES = [480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800]
MAX_SIZE = 1333
CANVAS = (800, 1344)


def _encoder():
    """(extension, encode) of the frames: JPEG where libjpeg builds, else
    PNG."""
    from ..native import encode_jpeg_rgb, jpeg_library

    try:
        jpeg_library()
        return "jpg", lambda img: encode_jpeg_rgb(img, 90)
    except RuntimeError:
        from ..data.png import encode_png

        return "png", encode_png


def write_coco_tree(root: str, n: int, hw=(1024, 2048), fog=0.0, seed=0):
    """`n` synthetic frames and their annotations.json under `root`;
    returns (the dataset over them, the image format)."""
    ext, encode = _encoder()
    gen = SyntheticDetectionDataset(n, hw, num_classes=8, seed=seed, fog=fog)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []
    for i in range(n):
        img, tgt = gen.load(i)
        name = f"{i:06d}.{ext}"
        with open(os.path.join(img_dir, name), "wb") as f:
            f.write(encode(img))
        images.append({"id": i, "file_name": name,
                       "width": hw[1], "height": hw[0]})
        for b, lbl in zip(tgt["boxes"], tgt["labels"]):
            x0, y0, x1, y1 = [float(v) for v in b]
            anns.append({"id": len(anns), "image_id": i,
                         "category_id": int(lbl),
                         "bbox": [x0, y0, x1 - x0, y1 - y0],
                         "area": (x1 - x0) * (y1 - y0), "iscrowd": 0})
    ann_file = os.path.join(root, "annotations.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c, "name": str(c)}
                                  for c in range(1, 9)]}, f)
    return CocoDetectionDataset(img_dir, ann_file), ext


def drain(it, n_batches: int, batch_imgs: int, device) -> dict:
    """Time `n_batches` batches of `it`, each moved to `device` and waited
    for."""
    t0 = time.perf_counter()
    n = 0
    for b in it:
        to_device(b, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        n += 1
        if n >= n_batches:
            break
    dt = time.perf_counter() - t0
    return {"img_per_s": round(n * batch_imgs / dt, 2),
            "ms_per_batch": round(1e3 * dt / n, 1)}


def run(args) -> list:
    device = resolve_device(args.device)
    rows = []
    with tempfile.TemporaryDirectory() as td:
        src, fmt = write_coco_tree(os.path.join(td, "src"), args.images,
                                   tuple(args.hw), seed=0)
        tgt, _ = write_coco_tree(os.path.join(td, "tgt"), args.images,
                                 tuple(args.hw), fog=0.35, seed=1)
        da = DAPairedDataset(src, tgt)
        train_tf = DATrainTransform(SCALES, MAX_SIZE, [400, 500, 600],
                                    [384, 600])
        eval_tf = EvalTransform(max(SCALES), MAX_SIZE)
        n_batches = max(2, args.images // args.batch - 1)
        common = {"threads": args.threads, "format": fmt,
                  "device": str(device)}
        for mode, strong in (("da_train_strong", True),
                             ("da_train_weak", False)):
            it = make_da_loader(da, args.batch, CANVAS, train_tf,
                                num_threads=args.threads,
                                compute_strong=strong)
            # a DA batch holds batch source + batch target images
            rows.append({"mode": mode, **common,
                         **drain(it, n_batches, 2 * args.batch, device)})
        ev = make_eval_loader(tgt, args.batch, CANVAS, eval_tf,
                              num_threads=args.threads)
        rows.append({"mode": "eval", **common,
                     **drain(iter(ev), n_batches, args.batch, device)})
    return rows


def get_args_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=32)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2,
                    help="images per domain per batch")
    ap.add_argument("--hw", type=int, nargs=2, default=[1024, 2048],
                    help="frame size H W")
    ap.add_argument("--device", default=None,
                    help="where the batches go (default: the CUDA card)")
    return ap


def main(argv=None):
    rows = run(get_args_parser().parse_args(argv))
    for r in rows:
        print(json.dumps(r))
    return rows


if __name__ == "__main__":
    main()
