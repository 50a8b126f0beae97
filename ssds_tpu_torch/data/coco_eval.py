"""The COCO detection (bbox) evaluation protocol in numpy (no pycocotools).

A copy of :mod:`ssds_tpu.data.coco_eval` (reference ``lib/dataset/coco.py``
delegates to pycocotools ``COCOeval``, bbox):

- IoU thresholds .50:.05:.95 (10), recall thresholds 0:.01:1 (101).
- Per-image, per-category greedy matching in descending score order; each
  detection takes the best still-unmatched GT above the IoU threshold.
- ``iscrowd`` GTs are IGNORE regions: IoU against a crowd is
  intersection-over-DETECTION-area, crowds may match any number of
  detections, and a detection whose only match is a crowd is neither TP nor
  FP. A detection prefers a real (non-ignored) GT over an ignored one.
- maxDets caps detections PER IMAGE (1/10/100), not globally.
- Area ranges all/small/medium/large ([0,32^2],[32^2,96^2],[96^2,1e5^2]):
  GTs outside the range are ignored; unmatched detections outside the range
  are ignored rather than counted as FP.
- Precision is interpolated monotonically non-increasing and sampled at the
  101 recall points; AP averages over categories present in the GT; AR is
  the max recall averaged over IoU thresholds and categories.

The public surface mirrors COCOeval's stats vector:
``[AP, AP50, AP75, APs, APm, APl, AR1, AR10, AR100, ARs, ARm, ARl]``.

Two of the JAX module's Python loops run as array operations here, with the
same results bit for bit (``tests/test_torch_port_coco.py``): an (image,
category) without GT skips the matching loop (nothing can match), and the
precision envelope is a reverse running maximum. Both loops grow with the
detection count, which an untrained 81-class model makes large (up to 100
per class per image).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def iou_xyxy(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU [D,G] for corner boxes; against a crowd GT the
    denominator is the DETECTION area (pycocotools ``iou`` semantics)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    lt = np.maximum(dt[:, None, :2], gt[None, :, :2])
    rb = np.minimum(dt[:, None, 2:4], gt[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = np.prod(np.clip(dt[:, 2:4] - dt[:, :2], 0, None), axis=1)
    area_g = np.prod(np.clip(gt[:, 2:4] - gt[:, :2], 0, None), axis=1)
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(iscrowd[None, :], area_d[:, None], union)
    return inter / np.maximum(union, 1e-12)


class _ImgCatEval:
    """Match results for one (image, category, area-range): the per-IoU
    detection match matrix plus ignore masks, trimmed to maxDets=max."""

    __slots__ = ("dt_scores", "dt_matched", "dt_ignore", "n_gt")

    def __init__(self, dt_scores, dt_matched, dt_ignore, n_gt):
        self.dt_scores = dt_scores      # [D] sorted desc
        self.dt_matched = dt_matched    # [T, D] bool: matched a real GT
        self.dt_ignore = dt_ignore      # [T, D] bool: ignore this det
        self.n_gt = n_gt                # non-ignored GT count


def _evaluate_img_cat(
    dt_boxes: np.ndarray,       # [D, 5] x1,y1,x2,y2,score
    gt_boxes: np.ndarray,       # [G, 4]
    gt_iscrowd: np.ndarray,     # [G] bool
    gt_area: np.ndarray,        # [G] float (annotation 'area' if known)
    area_rng: Tuple[float, float],
    max_det: int,
) -> _ImgCatEval:
    """pycocotools ``evaluateImg`` for one (image, category, area, maxDet)."""
    gt_ignore = gt_iscrowd | (gt_area < area_rng[0]) | (gt_area > area_rng[1])
    # GTs sorted: real first, ignored last (stable)
    g_order = np.argsort(gt_ignore, kind="stable")
    gt_boxes = gt_boxes[g_order]
    gt_iscrowd = gt_iscrowd[g_order]
    gt_ignore = gt_ignore[g_order]

    d_order = np.argsort(-dt_boxes[:, 4], kind="stable")[:max_det]
    dt_boxes = dt_boxes[d_order]
    D, G, T = len(dt_boxes), len(gt_boxes), len(IOU_THRS)

    ious = iou_xyxy(dt_boxes[:, :4], gt_boxes, gt_iscrowd)
    dt_matched = np.zeros((T, D), bool)
    dt_ignore = np.zeros((T, D), bool)
    gt_matched = np.zeros((T, G), bool)

    for ti, thr in enumerate(IOU_THRS if G else ()):
        for di in range(D):
            best_iou = min(thr, 1.0 - 1e-10)
            m = -1
            for gi in range(G):
                # a real GT already claimed stays claimed (crowds re-match)
                if gt_matched[ti, gi] and not gt_iscrowd[gi]:
                    continue
                # GTs are sorted real-first: once we hold a real match, an
                # ignored GT cannot improve it
                if m > -1 and not gt_ignore[m] and gt_ignore[gi]:
                    break
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                m = gi
            if m == -1:
                continue
            gt_matched[ti, m] = True
            dt_matched[ti, di] = not gt_ignore[m]
            dt_ignore[ti, di] = gt_ignore[m]

    # unmatched detections outside the area range are ignored, not FPs
    dt_area = np.prod(np.clip(dt_boxes[:, 2:4] - dt_boxes[:, :2], 0, None), axis=1)
    out_of_rng = (dt_area < area_rng[0]) | (dt_area > area_rng[1])
    unmatched = ~(dt_matched | dt_ignore)
    dt_ignore |= unmatched & out_of_rng[None, :]

    return _ImgCatEval(dt_boxes[:, 4], dt_matched, dt_ignore,
                       int((~gt_ignore).sum()))


def _accumulate(per_img: List[_ImgCatEval]) -> Tuple[np.ndarray, np.ndarray]:
    """Merge one category's per-image matches into (precision[T,101],
    recall[T]). Returns (None, None) when the category has no GT."""
    n_gt = sum(e.n_gt for e in per_img)
    if n_gt == 0:
        return None, None
    T = len(IOU_THRS)
    scores = np.concatenate([e.dt_scores for e in per_img]) if per_img else np.zeros(0)
    order = np.argsort(-scores, kind="mergesort")
    matched = np.concatenate([e.dt_matched for e in per_img], axis=1)[:, order] \
        if per_img else np.zeros((T, 0), bool)
    ignored = np.concatenate([e.dt_ignore for e in per_img], axis=1)[:, order] \
        if per_img else np.zeros((T, 0), bool)

    precision = np.zeros((T, len(REC_THRS)))
    recall = np.zeros(T)
    for ti in range(T):
        keep = ~ignored[ti]
        tps = np.cumsum(matched[ti][keep]).astype(np.float64)
        fps = np.cumsum(~matched[ti][keep]).astype(np.float64)
        if len(tps) == 0:
            continue
        rc = tps / n_gt
        pr = tps / np.maximum(tps + fps, 1e-12)
        recall[ti] = rc[-1]
        # monotone non-increasing interpolation then sample at REC_THRS
        pr = np.maximum.accumulate(pr[::-1])[::-1]
        inds = np.searchsorted(rc, REC_THRS, side="left")
        valid = inds < len(pr)
        precision[ti, valid] = pr[inds[valid]]
    return precision, recall


class COCOEvalResult(dict):
    """stats dict with the 12 COCOeval summary metrics."""

    def summary_lines(self) -> List[str]:
        fmt = (" Average Precision  (AP) @[ IoU={:<9} | area={:>6} | "
               "maxDets={:>3} ] = {:0.3f}")
        fmt_r = (" Average Recall     (AR) @[ IoU={:<9} | area={:>6} | "
                 "maxDets={:>3} ] = {:0.3f}")
        rows = [
            (fmt, "0.50:0.95", "all", 100, self["AP"]),
            (fmt, "0.50", "all", 100, self["AP50"]),
            (fmt, "0.75", "all", 100, self["AP75"]),
            (fmt, "0.50:0.95", "small", 100, self["APs"]),
            (fmt, "0.50:0.95", "medium", 100, self["APm"]),
            (fmt, "0.50:0.95", "large", 100, self["APl"]),
            (fmt_r, "0.50:0.95", "all", 1, self["AR1"]),
            (fmt_r, "0.50:0.95", "all", 10, self["AR10"]),
            (fmt_r, "0.50:0.95", "all", 100, self["AR100"]),
            (fmt_r, "0.50:0.95", "small", 100, self["ARs"]),
            (fmt_r, "0.50:0.95", "medium", 100, self["ARm"]),
            (fmt_r, "0.50:0.95", "large", 100, self["ARl"]),
        ]
        return [f.format(a, b, c, v) for f, a, b, c, v in rows]


def evaluate(
    gt_by_img_cat: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray, np.ndarray]],
    dt_by_img_cat: Dict[Tuple[int, int], np.ndarray],
    img_ids: Sequence[int],
    cat_ids: Sequence[int],
) -> COCOEvalResult:
    """Run the full bbox protocol.

    Args:
      gt_by_img_cat: (img_id, cat) -> (boxes [G,4] xyxy, iscrowd [G] bool,
        area [G] float). Missing keys mean no GT.
      dt_by_img_cat: (img_id, cat) -> [D,5] (x1,y1,x2,y2,score).
      img_ids / cat_ids: the full id spaces.

    Returns:
      COCOEvalResult with AP/AP50/AP75/APs/APm/APl/AR1/AR10/AR100/ARs/ARm/ARl
      (NaN-free: metrics over empty denominators are -1, like COCOeval).
    """
    empty_gt = (np.zeros((0, 4)), np.zeros(0, bool), np.zeros(0))
    empty_dt = np.zeros((0, 5))

    # precision[area][maxdet] over (T, R, K); recall likewise (T, K)
    ap_tables = {}
    ar_tables = {}
    for area_name, area_rng in AREA_RNGS.items():
        for max_det in MAX_DETS:
            if area_name != "all" and max_det != 100:
                continue  # COCOeval summarizes only these combos
            precs, recs = [], []
            for cat in cat_ids:
                per_img = []
                for iid in img_ids:
                    g_boxes, g_crowd, g_area = gt_by_img_cat.get((iid, cat), empty_gt)
                    d = dt_by_img_cat.get((iid, cat), empty_dt)
                    if len(g_boxes) == 0 and len(d) == 0:
                        continue
                    per_img.append(_evaluate_img_cat(
                        np.asarray(d, np.float64),
                        np.asarray(g_boxes, np.float64),
                        np.asarray(g_crowd, bool),
                        np.asarray(g_area, np.float64),
                        area_rng, max_det))
                p, r = _accumulate(per_img)
                if p is not None:
                    precs.append(p)
                    recs.append(r)
            ap_tables[(area_name, max_det)] = precs
            ar_tables[(area_name, max_det)] = recs

    def _ap(area, max_det, iou=None):
        precs = ap_tables[(area, max_det)]
        if not precs:
            return -1.0
        arr = np.stack(precs)  # [K, T, R]
        if iou is not None:
            ti = int(np.argmin(np.abs(IOU_THRS - iou)))
            arr = arr[:, ti:ti + 1]
        return float(arr.mean())

    def _ar(area, max_det):
        recs = ar_tables[(area, max_det)]
        if not recs:
            return -1.0
        return float(np.stack(recs).mean())

    return COCOEvalResult(
        AP=_ap("all", 100), AP50=_ap("all", 100, 0.5), AP75=_ap("all", 100, 0.75),
        APs=_ap("small", 100), APm=_ap("medium", 100), APl=_ap("large", 100),
        AR1=_ar("all", 1), AR10=_ar("all", 10), AR100=_ar("all", 100),
        ARs=_ar("small", 100), ARm=_ar("medium", 100), ARl=_ar("large", 100),
    )
