"""One-command mAP50 reproduction kit for the C2F headline number, on the
port (port of tools/repro_c2f.py).

The reference reports mAP50 52.8 on Cityscapes -> Foggy Cityscapes from its
published checkpoint, evaluated at the C2F 1.5x scales capped at 2048
(1216x2048 canvas). This tool chains every stage of reproducing that number
with datr_torch, with no JAX anywhere:

  1. stage    - copy / unzip the dataset tree onto local disk
                (tools/stage_data.py; layout <root>/city2foggy/
                {source,target,val}/{images,annotations.json})
  2. convert  - the reference .pth -> the port's checkpoint
                (tools/convert_checkpoint.py)
  3. eval     - python -m datr_torch.main --eval with the C2F config on the
                converted weights, on the card unless --device cpu
  4. diff     - mAP50 against --expect (default 52.8) within --tol

Usage (real artifacts):
  python -m datr_torch.tools.repro_c2f --ckpt /path/c2f_published.pth \\
      --data_src /shared/city2foggy --work_dir /local/repro

Offline dry run (no dataset or published .pth in the repository: it makes
a miniature dataset tree (PNG frames, COCO annotations) and a random .pth
in the reference's layout, with an `args` Namespace inside as the
reference's own checkpoints have, and drives every stage end to end at a
reduced model and canvas, so that the kit itself stays tested):
  python -m datr_torch.tools.repro_c2f --dry_run --work_dir /tmp/repro_dry \\
      [--device cpu]

Prints one JSON line per stage ({"stage": ..., "ok": true, ...}) and a
final verdict line {"repro": "c2f", "map50": ..., "expect": ..., "ok": ...}
(on a dry run the mAP is that of random weights on random frames: not
meaningful, and not compared).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

C2F_CONFIG = "configs/DA/Cityscapes2FoggyCityscapes/DINO_4scale_C2F.py"

# shrink to the test suite's shapes so the dry run takes seconds on a CPU
DRY_OPTIONS = [
    "num_classes=4", "dn_labelbook_size=4", "hidden_dim=32", "nheads=2",
    "enc_layers=1", "dec_layers=2", "dim_feedforward=64", "num_queries=16",
    "dn_number=4", "dn_single_pad=4", "canvas_h=96", "canvas_w=128",
    "max_boxes=8", "batch_size=2", "num_select=10",
    "data_aug_scales=[72,80]", "data_aug_max_size=120",
    "data_aug_scales2_resize=[64,72]", "data_aug_scales2_crop=[48,72]",
]


def _log(stage, **kw):
    print(json.dumps({"stage": stage, **kw}), flush=True)


# ------------------------------------------------------------------ stages


def stage_dataset(data_src: str, data_root: str) -> str:
    from .stage_data import stage_tree, stage_zip

    dst = os.path.join(data_root, "city2foggy")
    if data_src.endswith(".zip"):
        n = stage_zip(data_src, dst)
        info = dict(extracted=n)
    else:
        copied, skipped = stage_tree(data_src, dst)
        info = dict(copied=copied, skipped=skipped)
    p = os.path.join(dst, "val", "annotations.json")
    if not os.path.exists(p):
        raise FileNotFoundError(
            f"staged tree is missing {p}: expected the DA layout "
            "val/{images,annotations.json}")
    _log("stage", ok=True, src=data_src, dst=dst, **info)
    return dst


def convert_ckpt(torch_ckpt: str, config: str, out: str, key: str,
                 options=()) -> str:
    from .convert_checkpoint import main as convert_main

    convert_main(["--torch_ckpt", torch_ckpt, "--config", config,
                  "--out", out, "--key", key,
                  *(["--options", *options] if options else [])])
    _log("convert", ok=True, ckpt=torch_ckpt, key=key, out=out)
    return out


def run_eval(config: str, params_path: str, data_root: str, out_dir: str,
             options=(), device=None) -> dict:
    from ..main import get_args_parser, main

    args = get_args_parser().parse_args([
        "-c", config, "--eval", "--resume", params_path,
        "--data_root", data_root, "--output_dir", out_dir,
        *(["--device", device] if device else []),
        *(["--options", *options] if options else []),
    ])
    stats = main(args)
    if not stats or "ap50" not in stats:
        raise RuntimeError("eval produced no ap50 stat")
    _log("eval", ok=True, **{k: v for k, v in stats.items()
                             if isinstance(v, (int, float))})
    return stats


# ------------------------------------------------------- dry-run stand-ins


def make_synthetic_c2f_tree(src_dir: str, hw=(80, 112), n=4,
                            classes=3) -> str:
    """Miniature city2foggy-layout tree (PNG frames, COCO annotations):
    the stand-in for the dataset to stage."""
    import numpy as np

    from ..data.png import encode_png

    rng = np.random.default_rng(0)
    for split in ("source", "target", "val"):
        img_dir = os.path.join(src_dir, split, "images")
        os.makedirs(img_dir, exist_ok=True)
        images, anns = [], []
        h, w = hw
        for i in range(n):
            name = f"{split}_{i:04d}.png"
            with open(os.path.join(img_dir, name), "wb") as f:
                f.write(encode_png((rng.random((h, w, 3)) * 255)
                                   .astype(np.uint8)))
            images.append({"id": i, "file_name": name,
                           "height": h, "width": w})
            for j in range(2):
                x0, y0 = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
                bw, bh = rng.uniform(8, w / 3), rng.uniform(8, h / 3)
                anns.append({
                    "id": i * 10 + j, "image_id": i,
                    "category_id": int(rng.integers(1, classes + 1)),
                    "bbox": [x0, y0, bw, bh], "area": bw * bh,
                    "iscrowd": 0,
                })
        with open(os.path.join(src_dir, split, "annotations.json"),
                  "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": c, "name": f"c{c}"}
                                      for c in range(1, classes + 1)]}, f)
    return src_dir


def make_synthetic_reference_ckpt(out_pth: str, config: str,
                                  options) -> str:
    """A random-weight .pth in the reference's layout for `config` (the
    converter's `build_reference_state_dict`), with the `args` Namespace
    the reference's checkpoints carry: the stand-in for the published
    checkpoint."""
    import torch

    from .convert_checkpoint import build_reference_state_dict

    sd = {k: torch.from_numpy(v) for k, v in
          build_reference_state_dict(config, options).items()}
    torch.save({"model": sd, "ema_model": sd,
                "args": argparse.Namespace(config_file=config,
                                           options=list(options))}, out_pth)
    return out_pth


# -------------------------------------------------------------------- main


def get_args_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default="",
                    help="published reference checkpoint (.pth)")
    ap.add_argument("--ckpt_key", default="ema_model",
                    choices=["model", "ema_model"],
                    help="state dict to convert (the published C2F best "
                         "is the EMA track)")
    ap.add_argument("--data_src", default="",
                    help="dataset tree or .zip to stage; omit if "
                         "--data_root already holds city2foggy/")
    ap.add_argument("--data_root", default="")
    ap.add_argument("--work_dir", default="runs/repro_c2f")
    ap.add_argument("--config", default=C2F_CONFIG)
    ap.add_argument("--expect", type=float, default=52.8,
                    help="the reference's mAP50")
    ap.add_argument("--tol", type=float, default=0.5)
    ap.add_argument("--options", nargs="+", default=[])
    ap.add_argument("--device", default=None,
                    help="torch device of the eval (default: the card)")
    ap.add_argument("--dry_run", action="store_true",
                    help="make every missing artifact and drive all four "
                         "stages at reduced shapes (offline self-test)")
    return ap


def main(argv=None) -> dict:
    args = get_args_parser().parse_args(argv)
    os.makedirs(args.work_dir, exist_ok=True)
    data_root = args.data_root or os.path.join(args.work_dir, "data")
    options = list(args.options)

    if args.dry_run:
        options = DRY_OPTIONS + options
        if not args.data_src:
            args.data_src = make_synthetic_c2f_tree(
                os.path.join(args.work_dir, "synthetic_src"))
        if not args.ckpt:
            args.ckpt = make_synthetic_reference_ckpt(
                os.path.join(args.work_dir, "synthetic_ref.pth"),
                args.config, options)

    # 1. stage
    if args.data_src:
        stage_dataset(args.data_src, data_root)
    elif not os.path.isdir(os.path.join(data_root, "city2foggy")):
        raise FileNotFoundError(
            f"no dataset: pass --data_src or put city2foggy/ under "
            f"{data_root}")

    # 2. convert
    if not args.ckpt:
        raise FileNotFoundError("no checkpoint: pass --ckpt (the published "
                                ".pth of the reference)")
    params_path = convert_ckpt(
        args.ckpt, args.config, os.path.join(args.work_dir, "converted.pth"),
        args.ckpt_key, options)

    # 3. eval at the C2F canvas (the dry run shrinks it by DRY_OPTIONS)
    stats = run_eval(args.config, params_path, data_root,
                     os.path.join(args.work_dir, "eval"), options,
                     args.device)

    # 4. diff
    map50 = 100.0 * stats["ap50"]
    ok = abs(map50 - args.expect) <= args.tol
    verdict = {
        "repro": "c2f", "map50": map50, "expect": args.expect,
        "tol": args.tol, "ok": bool(ok), "dry_run": bool(args.dry_run),
        **({"note": "dry run: synthetic stand-ins, accuracy diff not "
                    "meaningful"} if args.dry_run else {}),
    }
    print(json.dumps(verdict))
    if not ok and not args.dry_run:
        sys.exit(1)
    return verdict


if __name__ == "__main__":
    main()
