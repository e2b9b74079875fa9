"""Panoptic-quality evaluation (PQ / SQ / RQ); the port's own copy of
datr_tpu/eval/panoptic_eval.py.

Capability match for the reference's datasets/panoptic_eval.py:13-44, which
wraps panopticapi.evaluation.pq_compute — a dead path in DATR (every config
sets masks=False) but part of the reference surface. panopticapi is not in
this image, so the PQ protocol itself is implemented here, following the
published algorithm (Kirillov et al., "Panoptic Segmentation"):

- segments match iff IoU > 0.5 (unique by construction);
- crowd GT segments never match and never count as FN; their pixels join
  the void region for the FP test;
- a predicted segment is dropped from FP counting when more than half of
  its area is void (incl. same-category crowd pixels);
- PQ = sum(IoU of TP) / (TP + FP/2 + FN/2), SQ = sum(IoU)/TP,
  RQ = TP / (TP + FP/2 + FN/2), averaged over categories present in GT.

Inputs are per-image id maps [H, W] of segment ids (0 = void / unlabeled)
plus {segment_id: category} dicts — the same information panopticapi decodes
from its PNG files; the reference writes those PNGs in PostProcessPanoptic
(models/dino/segmentation.py) and hands file names to pq_compute.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Mapping

import numpy as np

VOID = 0


class PanopticEvaluator:
    """Accumulates per-image panoptic predictions and computes PQ stats.

    Mirrors the reference evaluator's update / synchronize(merge) /
    summarize flow (datasets/panoptic_eval.py:23-44)."""

    def __init__(self):
        # per-category accumulators
        self.iou_sum: Dict[int, float] = defaultdict(float)
        self.tp: Dict[int, int] = defaultdict(int)
        self.fp: Dict[int, int] = defaultdict(int)
        self.fn: Dict[int, int] = defaultdict(int)
        self.categories: set = set()

    def add_image(
        self,
        pred_ids: np.ndarray,  # [H, W] int segment ids, 0 = void
        pred_cats: Mapping[int, int],  # segment id -> category
        gt_ids: np.ndarray,  # [H, W]
        gt_cats: Mapping[int, int],
        gt_iscrowd: Mapping[int, bool] | None = None,
    ):
        gt_iscrowd = gt_iscrowd or {}
        pred_ids = np.asarray(pred_ids)
        gt_ids = np.asarray(gt_ids)
        assert pred_ids.shape == gt_ids.shape

        gt_areas = {int(s): int(a) for s, a in
                    zip(*np.unique(gt_ids, return_counts=True)) if s != VOID}
        pred_areas = {int(s): int(a) for s, a in
                      zip(*np.unique(pred_ids, return_counts=True))
                      if s != VOID}
        self.categories.update(gt_cats[s] for s in gt_areas)

        # joint histogram of (gt segment, pred segment) pixel overlaps
        joint = gt_ids.astype(np.int64) * (pred_ids.max() + 1) + pred_ids
        pairs, counts = np.unique(joint, return_counts=True)
        inter: Dict[tuple, int] = {}
        base = int(pred_ids.max() + 1)
        for p, c in zip(pairs, counts):
            inter[(int(p) // base, int(p) % base)] = int(c)

        matched_gt, matched_pred = set(), set()
        for (gs, ps), c in inter.items():
            if gs == VOID or ps == VOID:
                continue
            if gt_iscrowd.get(gs, False):
                continue
            if gt_cats.get(gs) != pred_cats.get(ps):
                continue
            # union excludes the pred segment's overlap with GT void
            # (panopticapi evaluation.py pq_compute_single_core)
            union = (gt_areas[gs] + pred_areas[ps] - c
                     - inter.get((VOID, ps), 0))
            iou = c / union
            if iou > 0.5:
                cat = gt_cats[gs]
                self.tp[cat] += 1
                self.iou_sum[cat] += iou
                matched_gt.add(gs)
                matched_pred.add(ps)

        # FN: unmatched non-crowd GT segments
        for gs, _ in gt_areas.items():
            if gs in matched_gt or gt_iscrowd.get(gs, False):
                continue
            self.fn[gt_cats[gs]] += 1

        # FP: unmatched predictions, unless >50% of their area is void or
        # same-category crowd (panopticapi evaluation.py rule)
        crowd_by_cat: Dict[int, set] = defaultdict(set)
        for gs in gt_areas:
            if gt_iscrowd.get(gs, False):
                crowd_by_cat[gt_cats[gs]].add(gs)
        for ps, pa in pred_areas.items():
            if ps in matched_pred:
                continue
            ignored = inter.get((VOID, ps), 0)
            for gs in crowd_by_cat.get(pred_cats.get(ps), ()):
                ignored += inter.get((gs, ps), 0)
            if ignored / pa > 0.5:
                continue
            self.fp[pred_cats.get(ps, -1)] += 1
            if pred_cats.get(ps) is not None:
                self.categories.add(pred_cats[ps])

    def merge(self, others: Iterable["PanopticEvaluator"]):
        """Cross-process merge (reference synchronize_between_processes,
        panoptic_eval.py:30-35)."""
        for o in others:
            for cat in o.categories:
                self.categories.add(cat)
            for d_self, d_o in ((self.iou_sum, o.iou_sum),
                                (self.tp, o.tp), (self.fp, o.fp),
                                (self.fn, o.fn)):
                for k, v in d_o.items():
                    d_self[k] += v

    def summarize(self) -> Dict[str, float]:
        """Returns {'PQ', 'SQ', 'RQ', 'n'} averaged over categories, plus
        'per_class' with the per-category triples."""
        per_class = {}
        pqs, sqs, rqs = [], [], []
        for cat in sorted(self.categories):
            tp, fp, fn = self.tp[cat], self.fp[cat], self.fn[cat]
            iou = self.iou_sum[cat]
            if tp + fp + fn == 0:
                continue
            pq = iou / (tp + 0.5 * fp + 0.5 * fn)
            sq = iou / tp if tp else 0.0
            rq = tp / (tp + 0.5 * fp + 0.5 * fn)
            per_class[cat] = {"pq": pq, "sq": sq, "rq": rq}
            pqs.append(pq)
            sqs.append(sq)
            rqs.append(rq)
        n = len(pqs)
        return {
            "PQ": float(np.mean(pqs)) if n else 0.0,
            "SQ": float(np.mean(sqs)) if n else 0.0,
            "RQ": float(np.mean(rqs)) if n else 0.0,
            "n": n,
            "per_class": per_class,
        }
