"""Single-image inference CLI (port of datr_tpu/inference.py).

Load config + checkpoint (the student, the use_ema model_ema track or the
EMA teacher), resize the shorter side to 800 capped at 1333 (PIL's bilinear,
`data/pil_ops.py`), forward, postprocess at size (1, 1) -> normalized boxes,
score threshold 0.2, draw rectangles (and, for a model with masks, blend
each detection's instance mask first, `utils/visualizer.draw_masks`), save.
Runs on the CUDA card unless `--device cpu` is given. The image is decoded
without PIL where it is a JPEG or a PNG (`data.coco.decode_rgb`);
drawing and saving need PIL.

Usage:
  python -m datr_torch.inference -c configs/.../DINO_4scale_C2F.py \
      --ckpt runs/c2f/checkpoint --image in.png --out out.png [--ema]
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from .data import pil_ops
from .data.transforms import finalize_example, get_size_with_aspect_ratio
from .models.postprocess import postprocess
from .models.segmentation import det_mask_rles
from .train.checkpoint import _is_state, _load
from .utils.rle import decode_counts
from .utils.visualizer import draw_masks

CLASS_PALETTE = [
    (255, 99, 71), (65, 105, 225), (60, 179, 113), (238, 130, 238),
    (255, 165, 0), (106, 90, 205), (64, 224, 208), (218, 165, 32),
    (199, 21, 133), (0, 191, 255),
]


def run_inference(model, img_u8: np.ndarray, canvas_hw, num_select=300,
                  threshold=0.2, with_masks=False):
    """One image (uint8 [h, w, 3]) through `model` (in eval mode) on its
    own device: (boxes [N, 4] xyxy in original pixels, labels [N], scores
    [N]) of the detections scoring above `threshold`, and with `with_masks`
    (a model with masks) their original-size binary masks [N, h, w]
    (datr_tpu/inference.py:34-73: the f32 stride-4 logits finished by
    `det_mask_rles` on the host)."""
    h0, w0 = img_u8.shape[:2]
    oh, ow = get_size_with_aspect_ratio((w0, h0), 800, 1333)
    resized = pil_ops.resize_bilinear(np.asarray(img_u8, np.uint8), (ow, oh))
    ex = finalize_example(resized, None, canvas_hw, 1)
    dev = next(model.parameters()).device
    with torch.inference_mode():
        out = model(torch.from_numpy(ex["image"])[None].to(dev),
                    torch.from_numpy(ex["pad_mask"])[None].to(dev))
        res = postprocess(out["pred_logits"], out["pred_boxes"],
                          torch.ones((1, 2), device=dev),
                          num_select=num_select)
    scores = res["scores"][0].float().cpu().numpy()
    keep = scores > threshold
    # boxes are fractions of the image's extent -> original pixels
    boxes = res["boxes"][0].float().cpu().numpy()[keep] * np.array(
        [w0, h0, w0, h0], np.float32)
    labels = res["labels"][0].cpu().numpy()[keep]
    if not with_masks:
        return boxes, labels, scores[keep]
    queries = res["queries"][0].cpu().numpy()[keep]
    pm = out["pred_masks"][0].float().cpu().numpy()[queries]
    # real_size: the extent on the canvas (finalize_example rescales a
    # resize larger than the canvas)
    rles = det_mask_rles(pm, canvas_hw, tuple(ex["real_size"]), (h0, w0))
    masks = (np.stack([decode_counts(c, h0, w0) for c in rles]) if rles
             else np.zeros((0, h0, w0), bool))
    return boxes, labels, scores[keep], masks


def load_eval_params(ckpt_path: str, ema: bool = False,
                     teacher: bool = False) -> Dict[str, torch.Tensor]:
    """The serving / eval state_dict of a checkpoint in the port's format
    (datr_tpu/inference.py:76-89): from a whole training state, the
    student, the use_ema model_ema track (`ema`) or the pseudo-label EMA
    teacher (`teacher`); a params-only best-family tree as it is."""
    payload = _load(ckpt_path)
    if _is_state(payload):
        key = "model_ema" if ema else "ema_teacher" if teacher else "model"
        return payload.get(key) or payload["model"]
    return payload


def load_model(cfg, ckpt_path: str, ema: bool = False, teacher: bool = False,
               device=None):
    """The config's model on `device` (default: the card), in eval mode,
    with the weights `load_eval_params` picks."""
    from .models import build_model

    model, _, _ = build_model(cfg, device)
    model.load_state_dict(load_eval_params(ckpt_path, ema=ema,
                                           teacher=teacher))
    return model.eval()


def get_args_parser():
    """datr_tpu's flags (datr_tpu/inference.py:92-106) and `--device`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_file", "-c", required=True)
    ap.add_argument("--options", nargs="+", default=[])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--image", required=True)
    ap.add_argument("--out", default="inference_out.png")
    ap.add_argument("--ema", action="store_true",
                    help="use the --use_ema ModelEma weights")
    ap.add_argument("--teacher", action="store_true",
                    help="use the EMA-teacher (pseudo-label) track")
    ap.add_argument("--threshold", type=float, default=0.2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None):
    args = get_args_parser().parse_args(argv)

    from .config import apply_overrides, load_config
    from .data.coco import open_rgb

    cfg = apply_overrides(load_config(args.config_file), args.options)
    model = load_model(cfg, args.ckpt, ema=args.ema, teacher=args.teacher,
                       device=args.device)
    canvas_hw = (cfg.get("canvas_h", 800), cfg.get("canvas_w", 1344))
    img = open_rgb(args.image)
    with_masks = bool(getattr(model, "with_masks", False))
    r = run_inference(model, img, canvas_hw, cfg.get("num_select", 300),
                      args.threshold, with_masks=with_masks)
    boxes, labels, scores = r[:3]
    from PIL import Image, ImageDraw

    im = Image.fromarray(img)
    if with_masks and len(r[3]):
        im = draw_masks(im, r[3], labels)
    draw = ImageDraw.Draw(im)
    for b, l, s in zip(boxes, labels, scores):
        color = CLASS_PALETTE[int(l) % len(CLASS_PALETTE)]
        draw.rectangle(list(map(float, b)), outline=color, width=3)
        draw.text((float(b[0]), max(0.0, float(b[1]) - 12)),
                  f"{int(l)}:{s:.2f}", fill=color)
    im.save(args.out)
    print(f"saved {args.out} with {len(boxes)} detections")


if __name__ == "__main__":
    main()
