"""COCO-style detection mAP in pure numpy: the port's own copy of
datr_tpu/eval/coco_eval.py, box IoU ('bbox') or mask IoU ('segm', through
utils/rle.py's mask_iou, pycocotools' maskUtils.iou semantics).

It implements pycocotools' protocol (which the reference wraps,
datasets/coco_eval.py:22-266): greedy score-ordered matching at IoU
thresholds 0.50:0.05:0.95 with the crowd / ignore rules, 101-point
interpolated precision, area ranges (all/small/medium/large) on the
annotation area when given, maxDets 1/10/100 sliced after one maxDet=100
matching pass, and the standard 12-number summary. Index 1 is AP50, the
model-selection metric (main.py:416-515).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..utils.rle import area_of_counts, mask_iou, masks_to_rles

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_xyxy(d: np.ndarray, g: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """[D, G] IoU; for crowd GT the denominator is the detection area
    (pycocotools semantics)."""
    if len(d) == 0 or len(g) == 0:
        return np.zeros((len(d), len(g)))
    dx = np.clip(d[:, 2] - d[:, 0], 0, None)
    dy = np.clip(d[:, 3] - d[:, 1], 0, None)
    gx = np.clip(g[:, 2] - g[:, 0], 0, None)
    gy = np.clip(g[:, 3] - g[:, 1], 0, None)
    da = dx * dy
    ga = gx * gy
    lt = np.maximum(d[:, None, :2], g[None, :, :2])
    rb = np.minimum(d[:, None, 2:], g[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = np.where(iscrowd[None, :], da[:, None],
                     da[:, None] + ga[None, :] - inter)
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / np.where(union > 0, union, 1.0),
                       0.0)
    return iou


def _greedy_match(ious, g_ignore, crowd):
    """Vectorized pycocotools evaluateImg matching.

    ious [D, G] for score-sorted dets x ignore-sorted gts. Returns
    (dt_m [T, D], gt_m [T, G]) with -1 for unmatched. Semantics (cocoeval
    evaluateImg): per det, pick the max-IoU gt >= min(thr, 1-1e-10) among
    still-unmatched-or-crowd gts, preferring non-ignored gts over ignored
    ones regardless of IoU; ties go to the LATER gt index.
    """
    T = len(IOU_THRS)
    D, G = ious.shape
    dt_m = np.full((T, D), -1, np.int64)
    gt_m = np.full((T, G), -1, np.int64)
    if D == 0 or G == 0:
        return dt_m, gt_m
    thr = np.minimum(IOU_THRS, 1 - 1e-10)[:, None]  # [T, 1]
    # non-ignored gts are preferred over ignored ones regardless of IoU;
    # since IoU <= 1, a +2 bonus folds that two-tier preference into one
    # argmax (reversed for pycocotools' ties-to-LATER-index behavior)
    bonus = np.where(g_ignore, 0.0, 2.0)[None, :]  # [1, G]
    crowd_row = crowd[None, :]
    for di in range(D):
        iou_d = ious[di][None, :]  # [1, G]
        ok = ((gt_m < 0) | crowd_row) & (iou_d >= thr)
        m = np.where(ok, iou_d + bonus, -np.inf)
        pick = G - 1 - np.argmax(m[:, ::-1], axis=1)
        tsel = np.nonzero(ok.any(axis=1))[0]
        dt_m[tsel, di] = pick[tsel]
        gt_m[tsel, pick[tsel]] = di
    return dt_m, gt_m


class CocoEvaluator:
    """Accumulates per-image detections + GT, computes the 12 COCO stats.

    iou_type 'bbox' matches on box IoU, 'segm' on mask IoU (the reference's
    CocoEvaluator(base_ds, ('bbox', 'segm')) when masks are on). For 'segm'
    add_image takes the masks as binary [N, H, W] arrays or as lists of RLE
    counts with mask_size=(H, W); the detections' areas are their masks'."""

    def __init__(self, categories: Sequence[int], iou_type: str = "bbox"):
        assert iou_type in ("bbox", "segm"), iou_type
        self.categories = sorted(set(int(c) for c in categories))
        self.iou_type = iou_type
        self._gt: Dict[int, dict] = {}  # image_id -> gt dict
        self._dt: Dict[int, dict] = {}

    @staticmethod
    def _as_rles(masks, n):
        if isinstance(masks, (list, tuple)):  # already RLE counts
            rles = [np.asarray(c, np.int64) for c in masks]
        else:
            rles = masks_to_rles(masks)
        assert len(rles) == n, (len(rles), n)
        return rles

    # -- update API -------------------------------------------------------
    def add_image(
        self,
        image_id: int,
        gt_boxes: np.ndarray,  # [G, 4] xyxy absolute
        gt_labels: np.ndarray,  # [G]
        det_boxes: np.ndarray,  # [D, 4] xyxy absolute
        det_scores: np.ndarray,  # [D]
        det_labels: np.ndarray,  # [D]
        gt_iscrowd: np.ndarray | None = None,
        gt_areas: np.ndarray | None = None,  # annotation areas (segmentation
        # area in real COCO jsons); defaults to box area
        gt_masks=None,    # segm: [G, H, W] binary or list of RLE counts
        det_masks=None,   # segm: [D, H, W] binary or list of RLE counts
        mask_size=None,   # (H, W) when masks are passed as RLE counts
    ):
        image_id = int(image_id)
        gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        if gt_iscrowd is None:
            gt_iscrowd = np.zeros((len(gt_boxes),), bool)
        if gt_areas is None:
            gt_areas = (
                np.clip(gt_boxes[:, 2] - gt_boxes[:, 0], 0, None)
                * np.clip(gt_boxes[:, 3] - gt_boxes[:, 1], 0, None)
            )
        det_boxes = np.asarray(det_boxes, np.float64).reshape(-1, 4)
        gt, dt = {}, {}
        if self.iou_type == "segm":
            assert gt_masks is not None and det_masks is not None, (
                "segm evaluator needs gt_masks and det_masks")
            if mask_size is None:
                assert not isinstance(gt_masks, (list, tuple)), (
                    "mask_size=(H, W) is required with RLE-counts inputs")
                mask_size = np.asarray(gt_masks).shape[-2:]
            gt = {"rles": self._as_rles(gt_masks, len(gt_boxes)),
                  "hw": tuple(int(x) for x in mask_size)}
            dt = {"rles": self._as_rles(det_masks, len(det_boxes))}
        self._gt[image_id] = {
            "boxes": gt_boxes,
            "labels": np.asarray(gt_labels, np.int64).reshape(-1),
            "iscrowd": np.asarray(gt_iscrowd, bool).reshape(-1),
            "areas": np.asarray(gt_areas, np.float64).reshape(-1),
            **gt,
        }
        self._dt[image_id] = {
            "boxes": det_boxes,
            "scores": np.asarray(det_scores, np.float64).reshape(-1),
            "labels": np.asarray(det_labels, np.int64).reshape(-1),
            **dt,
        }

    # -- evaluation -------------------------------------------------------
    def _prep_img(self, img_id, cat, max_det):
        """Area-independent per-(image, category) state: score-sorted dets,
        GT arrays, and the IoU matrix — computed ONCE and reused by all 4
        area ranges (the IoUs don't depend on the range; pycocotools also
        computes computeIoU once per (img, cat))."""
        gt = self._gt[img_id]
        dt = self._dt[img_id]
        gm = gt["labels"] == cat
        dm = dt["labels"] == cat
        g = gt["boxes"][gm]
        crowd = gt["iscrowd"][gm]
        ga = gt["areas"][gm]
        d = dt["boxes"][dm]
        ds = dt["scores"][dm]
        order = np.argsort(-ds, kind="mergesort")[:max_det]
        d = d[order]
        ds = ds[order]
        if self.iou_type == "segm":
            # mask IoU, and the detections' mask areas (pycocotools' dtArea
            # for iouType 'segm')
            d_rles = [dt["rles"][i] for i in np.flatnonzero(dm)[order]]
            g_rles = [gt["rles"][i] for i in np.flatnonzero(gm)]
            h, w = gt["hw"]
            da = np.array([area_of_counts(c) for c in d_rles], np.float64)
            ious = mask_iou(d_rles, g_rles, crowd, h, w)
        else:
            da = np.clip(d[:, 2] - d[:, 0], 0, None) * np.clip(
                d[:, 3] - d[:, 1], 0, None
            )
            ious = _iou_xyxy(d, g, crowd)
        return {
            "g": g, "crowd": crowd, "ga": ga, "ds": ds, "da": da,
            "ious": ious,
        }

    def _evaluate_img(self, prep, area_rng):
        """One area-range matching pass over a _prep_img state
        (pycocotools COCOeval.evaluateImg)."""
        crowd = prep["crowd"]
        ga = prep["ga"]
        g_ignore = crowd | (ga < area_rng[0]) | (ga > area_rng[1])
        # sort gt: non-ignored first (pycocotools convention)
        g_order = np.argsort(g_ignore, kind="mergesort")
        g_ignore = g_ignore[g_order]
        crowd = crowd[g_order]
        ious = prep["ious"][:, g_order]

        dt_m, gt_m = _greedy_match(ious, g_ignore, crowd)

        T, D = dt_m.shape
        d_out_of_range = (prep["da"] < area_rng[0]) | (
            prep["da"] > area_rng[1]
        )
        matched = dt_m >= 0
        dt_ignore = np.zeros((T, D), bool)
        for t in range(T):
            m = matched[t]
            ig = np.zeros((D,), bool)
            ig[m] = g_ignore[dt_m[t][m]]
            dt_ignore[t] = ig | ((~m) & d_out_of_range)
        return {
            "scores": prep["ds"],
            "dt_matched": matched,
            "dt_ignore": dt_ignore,
            "n_gt": int((~g_ignore).sum()),
        }

    def accumulate(self) -> Dict[str, np.ndarray]:
        img_ids = sorted(self._gt.keys())
        T, R = len(IOU_THRS), len(REC_THRS)
        A, M, K = len(AREA_RANGES), len(MAX_DETS), len(self.categories)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        top_det = MAX_DETS[-1]

        for ki, cat in enumerate(self.categories):
            preps = [self._prep_img(i, cat, top_det) for i in img_ids]
            for ai, area_rng in enumerate(AREA_RANGES.values()):
                # one matching pass at maxDet=100; smaller maxDets are
                # prefix slices (pycocotools accumulate :0maxDet slicing —
                # valid because greedy matching of det i depends only on
                # dets before it)
                evs = [self._evaluate_img(p, area_rng) for p in preps]
                n_gt = sum(e["n_gt"] for e in evs)
                if n_gt == 0:
                    continue
                for mi, max_det in enumerate(MAX_DETS):
                    scores = np.concatenate(
                        [e["scores"][:max_det] for e in evs]
                    )
                    order = np.argsort(-scores, kind="mergesort")
                    matched = np.concatenate(
                        [e["dt_matched"][:, :max_det] for e in evs], axis=1
                    )[:, order]
                    ignored = np.concatenate(
                        [e["dt_ignore"][:, :max_det] for e in evs], axis=1
                    )[:, order]
                    tps = matched & ~ignored
                    fps = ~matched & ~ignored
                    tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t in range(T):
                        tp = tp_cum[t]
                        fp = fp_cum[t]
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[t, ki, ai, mi] = rc[-1] if len(rc) else 0.0
                        # monotone-decreasing interpolation from the right
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros((R,))
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[t, :, ki, ai, mi] = q
        return {"precision": precision, "recall": recall}

    def summarize(self) -> List[float]:
        acc = self.accumulate()

        def ap(iou=None, area="all", max_det=100):
            p = acc["precision"]
            ai = list(AREA_RANGES).index(area)
            mi = MAX_DETS.index(max_det)
            s = p[:, :, :, ai, mi]
            if iou is not None:
                s = s[np.where(np.isclose(IOU_THRS, iou))[0]]
            s = s[s > -1]
            return float(np.mean(s)) if s.size else -1.0

        def ar(area="all", max_det=100):
            r = acc["recall"]
            ai = list(AREA_RANGES).index(area)
            mi = MAX_DETS.index(max_det)
            s = r[:, :, ai, mi]
            s = s[s > -1]
            return float(np.mean(s)) if s.size else -1.0

        return [
            ap(), ap(0.5), ap(0.75),
            ap(area="small"), ap(area="medium"), ap(area="large"),
            ar(max_det=1), ar(max_det=10), ar(max_det=100),
            ar(area="small"), ar(area="medium"), ar(area="large"),
        ]
