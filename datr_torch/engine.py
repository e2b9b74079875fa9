"""Epoch loops: burn-in, single-domain, self-training, the per-epoch EMA
updates, evaluation and the --test dump (port of datr_tpu/engine.py).

The loops take batches as the host loaders make them (numpy dicts) or as
tensors; numpy arrays go to the model's device through pinned memory
without blocking. The training loops average the scalar metrics in a
MetricLogger and stop on a non-finite loss (reference engine.py:81-84). The
metrics stay on the device between drains: every DRAIN_EVERY steps one copy
brings them to the host, so the loop does not wait for the card each step.
Evaluation gives bbox AP, and with `segm` mask AP too. Across processes
each evaluates its own images (the eval loader's shard) and the detections
are all-gathered before the summary, so every process computes the same
global stats (datr_tpu/engine.py:383, 448).
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
from .models.segmentation import det_mask_rles
from .parallel import dist as pdist
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
        epoch: int = 0, teacher=None) -> Dict[str, float]:
    """Self-training epoch (datr_tpu/engine.py:118-139) over batches with
    `images_strong`; the EMA teacher, or the external `teacher` when given
    (distillation), labels the weak target half with per-class score
    thresholds `class_thresholds` [K]. Returns the mean of every metric,
    `num_pseudo` included."""
    thr = torch.as_tensor(class_thresholds, dtype=torch.float32,
                          device=_device(state))
    return _run_epoch(lambda b: train_step_self_training(
        state, b, ccfg, weight_dict, thr, tuple(canvas_hw),
        ema_decay=ema_decay, teacher=teacher), loader, _device(state),
        logger, f"SelfTrain Epoch: [{epoch}]")


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


def _to_host(k: str, v: torch.Tensor) -> np.ndarray:
    """A result on the host: a bf16 model's scores and boxes in f32; the f16
    mask logits copied as f16 and widened there."""
    if k == "mask_logits":
        return v.cpu().numpy().astype(np.float32)
    return (v.float() if v.is_floating_point() else v).cpu().numpy()


def _eval_batches(model, loader: Iterable, num_select: int,
                  nms_iou_threshold: float, not_to_xyxy: bool = False,
                  logger=None, with_masks: bool = False):
    """(results, batch GT) of each batch, as numpy on the host; with masks
    the GT also holds `real_sizes` and the `canvas_hw`."""
    dev = next(model.parameters()).device
    if logger:
        loader = MetricLogger(logger=logger).log_every(loader, 50, "Test:")
    keys = _GT_KEYS + (("real_sizes",) if with_masks else ())
    for batch in loader:
        res = eval_step(model, to_device(batch, dev, ("images", "pad_mask",
                                                      "orig_sizes")),
                        num_select=num_select,
                        nms_iou_threshold=nms_iou_threshold,
                        not_to_xyxy=not_to_xyxy, with_masks=with_masks)
        gt = {k: _host(batch[k]) for k in keys}
        gt["canvas_hw"] = tuple(batch["images"].shape[1:3])
        yield {k: _to_host(k, v) for k, v in res.items()}, gt


def evaluate(model, loader: Iterable, categories: Sequence[int],
             num_select: int = 300, nms_iou_threshold: float = -1.0,
             logger=None, save_results_path: Optional[str] = None,
             segm: bool = False) -> Dict:
    """Detection eval of `model` (the student or an EMA track) over eval
    batches (`EvalLoader`'s or `synthetic_eval_batches`'): the 12 COCO
    stats (datr_tpu/engine.py:161-323 -> coco_eval_bbox) and AP50. A
    positive `nms_iou_threshold` applies the class-aware eval NMS
    (dino.py:989-992). The ground truth is the raw annotations when the
    loader's dataset has `eval_annotations` (crowd regions and annotation
    areas, as the reference evaluates against the COCO API's GT), else the
    batches' boxes. `save_results_path` dumps each image's detections and
    GT to an npz (`results`: one dict per image). `segm` (a model with
    masks, a dataset whose eval_annotations give GT masks) adds the 12 mask
    AP stats, `coco_eval_masks` (datr_tpu/engine.py:166-322): each
    detection's f16 stride-4 logits finished on the host
    (`det_mask_rles`)."""
    evaluator = CocoEvaluator(categories)
    evaluator_m = CocoEvaluator(categories, iou_type="segm") if segm else None
    raw_gt = getattr(getattr(loader, "dataset", None), "eval_annotations",
                     None)
    if segm and raw_gt is None:
        raise ValueError("segm eval needs dataset.eval_annotations")
    dumped = [] if save_results_path else None
    # per-image records for the merge, kept only when one will run
    multi = pdist.process_count() > 1
    det_records, segm_records, max_boxes = [], [], None
    for res, gt in _eval_batches(model, loader, num_select,
                                 float(nms_iou_threshold), logger=logger,
                                 with_masks=segm):
        max_boxes = gt["boxes"].shape[1]
        for i, image_id in enumerate(gt["image_ids"]):
            if not gt["batch_valid"][i]:
                continue
            db, ds, dl = res["boxes"][i], res["scores"][i], res["labels"][i]
            if "valid" in res:  # NMS: the surviving detections only
                keep = res["valid"][i]
                db, ds, dl = db[keep], ds[keep], dl[keep]
            if raw_gt is not None:
                ann = (raw_gt(int(image_id), with_masks=True) if segm
                       else raw_gt(int(image_id)))
                gt_kw = dict(gt_boxes=ann["boxes"], gt_labels=ann["labels"],
                             gt_iscrowd=ann["iscrowd"],
                             gt_areas=ann["areas"])
            else:
                gv = gt["valid"][i]
                gt_xyxy = _gt_xyxy(gt["boxes"][i], gt["orig_sizes"][i])
                gt_kw = dict(gt_boxes=gt_xyxy[gv],
                             gt_labels=gt["labels"][i][gv])
            evaluator.add_image(int(image_id), det_boxes=db, det_scores=ds,
                                det_labels=dl, **gt_kw)
            if multi:
                rec = dict(image_id=int(image_id), boxes=res["boxes"][i],
                           scores=(res["scores"][i] if "valid" not in res
                                   else np.where(res["valid"][i],
                                                 res["scores"][i], -1.0)),
                           labels=res["labels"][i])
                if raw_gt is None:  # no shared annotations: GT travels
                    rec.update(gt_boxes=gt_xyxy, gt_labels=gt["labels"][i],
                               gt_valid=gv)
                det_records.append(rec)
            if evaluator_m is not None:
                if "masks" not in ann:
                    raise ValueError("segm eval needs GT mask RLEs from "
                                     "eval_annotations(with_masks=True)")
                ml_i = res["mask_logits"][i]
                if "valid" in res:
                    ml_i = ml_i[keep]
                oh, ow = gt["orig_sizes"][i]
                rles = det_mask_rles(ml_i, gt["canvas_hw"],
                                     tuple(gt["real_sizes"][i]), (oh, ow))
                evaluator_m.add_image(
                    int(image_id), det_boxes=db, det_scores=ds, det_labels=dl,
                    gt_masks=ann["masks"], det_masks=rles,
                    mask_size=ann["mask_size"], **gt_kw)
                if multi:
                    segm_records.append(dict(image_id=int(image_id),
                                             boxes=db, scores=ds, labels=dl,
                                             rles=rles))
            if dumped is not None:
                dumped.append(dict(image_id=int(image_id), boxes=db,
                                   scores=ds, labels=dl, **gt_kw))
    if dumped is not None:
        np.savez_compressed(save_results_path,
                            results=np.array(dumped, dtype=object))
    if multi:
        # the payloads' shapes are config constants (num_select, the
        # loader's max_boxes), equal on every process
        merge_across_processes(evaluator, det_records, raw_gt, num_select,
                               max_boxes or 1)
        if evaluator_m is not None:
            merge_segm_across_processes(evaluator_m, segm_records, raw_gt)
    stats = evaluator.summarize()
    if logger:
        logger.info("COCO stats: AP=%.4f AP50=%.4f AP75=%.4f"
                    % tuple(stats[:3]))
    out = {"coco_eval_bbox": stats, "ap50": stats[1]}
    if evaluator_m is not None:
        out["coco_eval_masks"] = evaluator_m.summarize()
        if logger:
            logger.info("COCO segm stats: AP=%.4f AP50=%.4f AP75=%.4f"
                        % tuple(out["coco_eval_masks"][:3]))
    return out


def merge_across_processes(evaluator: CocoEvaluator, det_records: List[dict],
                           raw_gt, num_select: int, max_boxes: int):
    """Add every other process's detections to `evaluator`
    (datr_tpu/engine.py:383 `_merge_across_processes`; reference
    CocoEvaluator.synchronize_between_processes): fixed-shape arrays, padded
    to the largest image count and all-gathered; an NMS-dropped detection
    carries score -1. GT travels only without raw annotations (`raw_gt`
    None); with them each process looks the other's images up."""
    n_max = int(pdist.all_gather_numpy(np.array(len(det_records))).max())
    ids = np.full((n_max,), -1, np.int64)
    boxes = np.zeros((n_max, num_select, 4), np.float32)
    scores = np.full((n_max, num_select), -1.0, np.float32)
    labels = np.zeros((n_max, num_select), np.int32)
    gt_boxes = np.zeros((n_max, max_boxes, 4), np.float64)
    gt_labels = np.zeros((n_max, max_boxes), np.int32)
    gt_valid = np.zeros((n_max, max_boxes), bool)
    for i, r in enumerate(det_records):
        ids[i] = r["image_id"]
        boxes[i], scores[i], labels[i] = r["boxes"], r["scores"], r["labels"]
        if raw_gt is None:
            gt_boxes[i] = r["gt_boxes"]
            gt_labels[i] = r["gt_labels"]
            gt_valid[i] = r["gt_valid"]
    g_ids, g_boxes, g_scores, g_labels, g_gtb, g_gtl, g_gtv = \
        pdist.all_gather_numpy((ids, boxes, scores, labels, gt_boxes,
                                gt_labels, gt_valid))
    me = pdist.process_index()
    for p in range(pdist.process_count()):
        if p == me:
            continue
        for i in range(n_max):
            iid = int(g_ids[p, i])
            if iid < 0:
                continue
            keep = g_scores[p, i] >= 0  # NMS-dropped entries carry -1
            if raw_gt is not None:
                ann = raw_gt(iid)
                gt_kw = dict(gt_boxes=ann["boxes"], gt_labels=ann["labels"],
                             gt_iscrowd=ann["iscrowd"],
                             gt_areas=ann["areas"])
            else:
                gv = g_gtv[p, i]
                gt_kw = dict(gt_boxes=g_gtb[p, i][gv],
                             gt_labels=g_gtl[p, i][gv])
            evaluator.add_image(iid, det_boxes=g_boxes[p, i][keep],
                                det_scores=g_scores[p, i][keep],
                                det_labels=g_labels[p, i][keep], **gt_kw)


def merge_segm_across_processes(evaluator_m: CocoEvaluator,
                                segm_records: List[dict], raw_gt):
    """Add every other process's mask detections to `evaluator_m`
    (datr_tpu/engine.py:448 `_merge_segm_across_processes`). The RLEs are
    ragged, so each process's travel as one flat int64 buffer, per image
    [image_id, D] then per detection [label, len(counts), counts...], with
    a parallel [N_det, 5] f64 buffer of (score, xyxy box), both padded to
    the largest process's length. The GT masks come from the annotations."""
    ints: List[int] = []
    floats: List[List[float]] = []
    for r in segm_records:
        ints += [r["image_id"], len(r["scores"])]
        for j in range(len(r["scores"])):
            c = np.asarray(r["rles"][j], np.int64)
            ints += [int(r["labels"][j]), len(c), *c.tolist()]
            floats.append([float(r["scores"][j]), *map(float, r["boxes"][j])])
    ibuf = np.asarray(ints, np.int64)
    fbuf = (np.asarray(floats, np.float64).reshape(-1, 5) if floats
            else np.zeros((0, 5)))
    lens = pdist.all_gather_numpy(
        np.array([ibuf.size, fbuf.shape[0]], np.int64))  # [P, 2]
    pad_i = np.zeros((int(lens[:, 0].max()),), np.int64)
    pad_i[:ibuf.size] = ibuf
    pad_f = np.zeros((int(lens[:, 1].max()), 5), np.float64)
    pad_f[:fbuf.shape[0]] = fbuf
    g_i, g_f = pdist.all_gather_numpy((pad_i, pad_f))
    me = pdist.process_index()
    for p in range(pdist.process_count()):
        if p == me:
            continue
        buf, fl = g_i[p][:int(lens[p, 0])], g_f[p][:int(lens[p, 1])]
        pos = det = 0
        while pos < buf.size:
            iid, n_det = int(buf[pos]), int(buf[pos + 1])
            pos += 2
            labels, rles = [], []
            for _ in range(n_det):
                lab, n = int(buf[pos]), int(buf[pos + 1])
                pos += 2
                rles.append(buf[pos:pos + n].copy())
                pos += n
                labels.append(lab)
            f = fl[det:det + n_det]
            det += n_det
            ann = raw_gt(iid, with_masks=True)
            evaluator_m.add_image(
                iid, det_boxes=f[:, 1:5].reshape(-1, 4), det_scores=f[:, 0],
                det_labels=np.asarray(labels, np.int64),
                gt_boxes=ann["boxes"], gt_labels=ann["labels"],
                gt_iscrowd=ann["iscrowd"], gt_areas=ann["areas"],
                gt_masks=ann["masks"], det_masks=rles,
                mask_size=ann["mask_size"])


def test(model, loader: Iterable, output_dir: Optional[str],
         num_select: int = 300, nms_iou_threshold: float = -1.0,
         logger=None) -> List[dict]:
    """--test mode (reference engine.py:527-597): every detection as a
    COCO-format record, boxes cxcywh in original-image pixels, written to
    `<output_dir>/results{rank}.json` (each process its own images). With
    eval NMS, the survivors only: NMS runs on xyxy boxes and the kept ones
    are converted back (the reference would run it on the cxcywh
    tensors)."""
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
        path = os.path.join(output_dir,
                            f"results{pdist.process_index()}.json")
        with open(path, "w") as f:
            json.dump(final_res, f)
        if logger:
            logger.info(f"wrote {len(final_res)} detections to {path}")
    return final_res
