"""Epoch loops: burn-in, single-domain, self-training, the per-epoch EMA
updates, evaluation and the --test dump (port of datr_tpu/engine.py).

The loops take batches as the host loaders make them (numpy dicts) or as
tensors; numpy arrays go to the model's device through pinned memory
without blocking. The training loops average the scalar metrics in a
MetricLogger and stop on a non-finite loss (reference engine.py:81-84). The
metrics stay on the device between drains: every DRAIN_EVERY steps one copy
brings them to the host, so the loop does not wait for the card each step.
Evaluation is single-process and bbox only.
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .data.loader import to_device
from .eval.coco_eval import CocoEvaluator
from .train.criterion import CriterionCfg
from .train.ema import cosine_decay, ema_update, ramped_decay
from .train.state import TrainState
from .train.steps import (
    eval_step,
    train_step_burnin,
    train_step_plain,
    train_step_self_training,
)
from .utils.logger import MetricLogger

DRAIN_EVERY = 10  # steps between host copies of the metrics


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _drain(pending: List[Dict[str, torch.Tensor]], ml: MetricLogger):
    """One host copy of the pending metric dicts; exit on a non-finite
    loss."""
    if not pending:
        return
    keys = list(pending[0])
    host = torch.stack([torch.stack([m[k].float() for k in keys])
                        for m in pending]).cpu().tolist()
    for row in host:
        metrics = dict(zip(keys, row))
        if not math.isfinite(metrics["loss"]):
            print(f"Loss is {metrics['loss']}, stopping training",
                  file=sys.stderr)
            sys.exit(1)
        ml.update(**metrics)
    pending.clear()


def _run_epoch(step: Callable[[Dict[str, torch.Tensor]],
                              Dict[str, torch.Tensor]],
               loader: Iterable, device: torch.device, logger=None,
               header: str = "") -> Dict[str, float]:
    """Steps over `loader` with the windowed drain; the mean of every
    metric. With a logger, a progress line after each drain."""
    ml = MetricLogger(logger=logger)
    batches = ml.log_every(loader, DRAIN_EVERY, header) if logger else loader
    pending: List[Dict[str, torch.Tensor]] = []
    for i, batch in enumerate(batches):
        pending.append(step(to_device(batch, device)))
        if i % DRAIN_EVERY == 0:
            _drain(pending, ml)
    _drain(pending, ml)
    return {k: m.global_avg for k, m in ml.meters.items()}


def _device(state: TrainState) -> torch.device:
    return state.global_proto.device


def train_one_epoch(state: TrainState, loader: Iterable,
                    ccfg: CriterionCfg, weight_dict: Dict[str, float],
                    ema_decay: float = 0.0, logger=None, epoch: int = 0
                    ) -> Dict[str, float]:
    """Burn-in epoch over paired batches (`make_da_loader`'s or
    `synthetic_da_batch`'s; the strong views are dropped). Returns the mean
    of every metric."""
    return _run_epoch(lambda b: train_step_burnin(
        state, b, ccfg, weight_dict, ema_decay=ema_decay),
        ({k: v for k, v in b.items()
          if k not in ("images_strong", "real_sizes")} for b in loader),
        _device(state), logger, f"Epoch: [{epoch}]")


def train_one_epoch_plain(state: TrainState, loader: Iterable,
                          ccfg: CriterionCfg, weight_dict: Dict[str, float],
                          ema_decay: float = 0.0, logger=None,
                          epoch: int = 0) -> Dict[str, float]:
    """Single-domain supervised epoch (datr_tpu/engine.py:100-115) over
    `make_single_loader`'s batches."""
    return _run_epoch(lambda b: train_step_plain(
        state, b, ccfg, weight_dict, ema_decay=ema_decay), loader,
        _device(state), logger, f"Epoch: [{epoch}]")


def train_one_epoch_self_training(
        state: TrainState, loader: Iterable, ccfg: CriterionCfg,
        weight_dict: Dict[str, float], class_thresholds,
        canvas_hw: Tuple[int, int], ema_decay: float = 0.0, logger=None,
        epoch: int = 0) -> Dict[str, float]:
    """Self-training epoch (datr_tpu/engine.py:118-139) over batches with
    `images_strong`; the EMA teacher labels the weak target half with
    per-class score thresholds `class_thresholds` [K]. Returns the mean of
    every metric, `num_pseudo` included."""
    thr = torch.as_tensor(class_thresholds, dtype=torch.float32,
                          device=_device(state))
    return _run_epoch(lambda b: train_step_self_training(
        state, b, ccfg, weight_dict, thr, tuple(canvas_hw),
        ema_decay=ema_decay), loader, _device(state), logger,
        f"SelfTrain Epoch: [{epoch}]")


def update_emas_per_epoch(state: TrainState, epoch: int, cfg) -> TrainState:
    """main.py:382-386: the teacher takes the student at the ramped decay
    of its update count, then the best track takes the teacher at the
    cosine decay of the self-training epoch. In place; returns `state`."""
    updates = state.ema_updates + 1
    ema_update(state.ema_teacher, state.model,
               ramped_decay(cfg.get("ema_decay_teacher", 0.9997), updates))
    burn = int(cfg.get("burn_epochs", 40))
    total = max(int(cfg.get("epochs", 36)) - burn, 1)
    ema_update(state.best_ema, state.ema_teacher,
               cosine_decay(cfg.get("ema_decay_best_model", 0.9), 0.9999,
                            max(epoch - burn, 0), total))
    state.ema_updates = updates
    return state


def _gt_xyxy(boxes: np.ndarray, orig_hw) -> np.ndarray:
    """Normalized cxcywh -> absolute xyxy in the original image."""
    oh, ow = orig_hw
    b = np.asarray(boxes, np.float64)
    cx, cy, w, h = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                    1) * np.array([ow, oh, ow, oh])


_GT_KEYS = ("image_ids", "batch_valid", "orig_sizes", "boxes", "labels",
            "valid")


def _eval_batches(model, loader: Iterable, num_select: int,
                  nms_iou_threshold: float, not_to_xyxy: bool = False,
                  logger=None):
    """(results, batch GT) of each batch, as numpy on the host."""
    dev = next(model.parameters()).device
    if logger:
        loader = MetricLogger(logger=logger).log_every(loader, 50, "Test:")
    for batch in loader:
        res = eval_step(model, to_device(batch, dev, ("images", "pad_mask",
                                                      "orig_sizes")),
                        num_select=num_select,
                        nms_iou_threshold=nms_iou_threshold,
                        not_to_xyxy=not_to_xyxy)
        # a bf16 model's scores reach the evaluator and the JSON in f32
        yield ({k: (v.float() if v.is_floating_point() else v).cpu().numpy()
                for k, v in res.items()},
               {k: _host(batch[k]) for k in _GT_KEYS})


def evaluate(model, loader: Iterable, categories: Sequence[int],
             num_select: int = 300, nms_iou_threshold: float = -1.0,
             logger=None, save_results_path: Optional[str] = None) -> Dict:
    """Detection eval of `model` (the student or an EMA track) over eval
    batches (`EvalLoader`'s or `synthetic_eval_batches`'): the 12 COCO
    stats (datr_tpu/engine.py:161-323 -> coco_eval_bbox) and AP50. A
    positive `nms_iou_threshold` applies the class-aware eval NMS
    (dino.py:989-992). The ground truth is the raw annotations when the
    loader's dataset has `eval_annotations` (crowd regions and annotation
    areas, as the reference evaluates against the COCO API's GT), else the
    batches' boxes. `save_results_path` dumps each image's detections and
    GT to an npz (`results`: one dict per image)."""
    evaluator = CocoEvaluator(categories)
    raw_gt = getattr(getattr(loader, "dataset", None), "eval_annotations",
                     None)
    dumped = [] if save_results_path else None
    for res, gt in _eval_batches(model, loader, num_select,
                                 float(nms_iou_threshold), logger=logger):
        for i, image_id in enumerate(gt["image_ids"]):
            if not gt["batch_valid"][i]:
                continue
            db, ds, dl = res["boxes"][i], res["scores"][i], res["labels"][i]
            if "valid" in res:  # NMS: the surviving detections only
                keep = res["valid"][i]
                db, ds, dl = db[keep], ds[keep], dl[keep]
            if raw_gt is not None:
                ann = raw_gt(int(image_id))
                gt_kw = dict(gt_boxes=ann["boxes"], gt_labels=ann["labels"],
                             gt_iscrowd=ann["iscrowd"],
                             gt_areas=ann["areas"])
            else:
                gv = gt["valid"][i]
                gt_kw = dict(
                    gt_boxes=_gt_xyxy(gt["boxes"][i], gt["orig_sizes"][i])[gv],
                    gt_labels=gt["labels"][i][gv])
            evaluator.add_image(int(image_id), det_boxes=db, det_scores=ds,
                                det_labels=dl, **gt_kw)
            if dumped is not None:
                dumped.append(dict(image_id=int(image_id), boxes=db,
                                   scores=ds, labels=dl, **gt_kw))
    if dumped is not None:
        np.savez_compressed(save_results_path,
                            results=np.array(dumped, dtype=object))
    stats = evaluator.summarize()
    if logger:
        logger.info("COCO stats: AP=%.4f AP50=%.4f AP75=%.4f"
                    % tuple(stats[:3]))
    return {"coco_eval_bbox": stats, "ap50": stats[1]}


def test(model, loader: Iterable, output_dir: Optional[str],
         num_select: int = 300, nms_iou_threshold: float = -1.0,
         logger=None) -> List[dict]:
    """--test mode (reference engine.py:527-597): every detection as a
    COCO-format record, boxes cxcywh in original-image pixels, written to
    `<output_dir>/results0.json`. With eval NMS, the survivors only: NMS
    runs on xyxy boxes and the kept ones are converted back (the reference
    would run it on the cxcywh tensors)."""
    use_nms = nms_iou_threshold > 0
    final_res = []
    for res, gt in _eval_batches(model, loader, num_select,
                                 float(nms_iou_threshold),
                                 not_to_xyxy=not use_nms, logger=logger):
        for i, image_id in enumerate(gt["image_ids"]):
            if not gt["batch_valid"][i]:
                continue
            boxes = np.asarray(res["boxes"][i], np.float64)
            scores, labels = res["scores"][i], res["labels"][i]
            if use_nms:  # xyxy survivors -> cxcywh
                keep = res["valid"][i]
                boxes, scores, labels = boxes[keep], scores[keep], \
                    labels[keep]
                x0, y0, x1, y1 = boxes.T
                boxes = np.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0,
                                  y1 - y0], 1)
            for sc, lab, b in zip(scores, labels, boxes):
                final_res.append({"image_id": int(image_id),
                                  "category_id": int(lab),
                                  "bbox": [float(x) for x in b],
                                  "score": float(sc)})
    if output_dir:
        path = os.path.join(output_dir, "results0.json")
        with open(path, "w") as f:
            json.dump(final_res, f)
        if logger:
            logger.info(f"wrote {len(final_res)} detections to {path}")
    return final_res
