"""Pure-numpy COCO detection evaluation (COCOeval-equivalent).

A copy of ``centernet_uda_tpu/evaluation/coco_eval_np.py``. Its greedy
matcher runs in the host library (``native.coco_greedy_match``, where the
JAX evaluator calls its own C++ matcher), or, with
``CENTERNET_DISABLE_NATIVE`` set, in Python (``greedy_match``, its plain
version, which gives the same arrays). It re-implements the COCO mAP
protocol that the reference's ``evaluation/coco.py`` drives through
``pycocotools.cocoeval.COCOeval``: 10 IoU thresholds 0.50:0.05:0.95, 101
recall thresholds, area ranges all/small/medium/large, maxDets [1, 10, 100],
greedy score-ordered matching with ignore handling, and the
precision (T, R, K, A, M) / recall (T, K, A, M) accumulation tables.

Axis-aligned boxes use the standard corner-intersection IoU (pycocotools
``bbox`` mode). Rotated boxes use exact convex-polygon IoU
(Sutherland–Hodgman clipping) instead of the reference's rasterized
RLE-mask IoU (evaluation/coco.py:317-329) — equivalent up to rasterization
error and much faster on the host.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from centernet_uda_torch import native

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
MAX_DETS = (1, 10, 100)
AREA_RNG = (
    (0.0, 1e10),
    (0.0, 32.0 ** 2),
    (32.0 ** 2, 96.0 ** 2),
    (96.0 ** 2, 1e10),
)
AREA_LBL = ("all", "small", "medium", "large")


def bbox_iou_matrix(dts: np.ndarray, gts: np.ndarray,
                    crowd: Optional[np.ndarray] = None) -> np.ndarray:
    """IoU between (D, 4) and (G, 4) x1y1x2y2 boxes -> (D, G).

    For ``iscrowd`` gts pycocotools uses the *expected* IoU —
    intersection over detection area instead of union (maskUtils.iou
    semantics driven by cocoeval.computeIoU's iscrowd list)."""
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    dts = dts.astype(np.float64)
    gts = gts.astype(np.float64)
    ix1 = np.maximum(dts[:, None, 0], gts[None, :, 0])
    iy1 = np.maximum(dts[:, None, 1], gts[None, :, 1])
    ix2 = np.minimum(dts[:, None, 2], gts[None, :, 2])
    iy2 = np.minimum(dts[:, None, 3], gts[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area_d = (dts[:, 2] - dts[:, 0]) * (dts[:, 3] - dts[:, 1])
    area_g = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    if crowd is not None and np.any(crowd):
        union = np.where(np.asarray(crowd, bool)[None, :],
                         np.broadcast_to(area_d[:, None], union.shape), union)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _signed_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman: clip convex ``subject`` polygon by convex ``clip``."""
    if _signed_area(clip) < 0:  # normalize clip to CCW winding
        clip = clip[::-1]
    output = list(subject)
    for i in range(len(clip)):
        a = clip[i]
        b = clip[(i + 1) % len(clip)]
        edge = (b[0] - a[0], b[1] - a[1])
        input_pts, output = output, []
        if not input_pts:
            break

        def inside(p):
            return edge[0] * (p[1] - a[1]) - edge[1] * (p[0] - a[0]) >= -1e-12

        def intersect(p, q):
            dp = (q[0] - p[0], q[1] - p[1])
            denom = edge[0] * dp[1] - edge[1] * dp[0]
            if abs(denom) < 1e-12:
                return q
            t = (edge[0] * (a[1] - p[1]) - edge[1] * (a[0] - p[0])) / denom
            return (p[0] + t * dp[0], p[1] + t * dp[1])

        prev = input_pts[-1]
        for cur in input_pts:
            if inside(cur):
                if not inside(prev):
                    output.append(intersect(prev, cur))
                output.append(tuple(cur))
            elif inside(prev):
                output.append(intersect(prev, cur))
            prev = cur
    return np.array(output) if output else np.zeros((0, 2))


def _polygon_area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def _rotated_to_polygon(box: Sequence[float]) -> np.ndarray:
    """(cx, cy, w, h, angle_deg) -> (4, 2) corner polygon (counter-/clockwise
    consistent with utils/box.py:41-52 rotation convention)."""
    cx, cy, w, h, angle = [float(v) for v in box[:5]]
    c, s = np.cos(np.radians(angle)), np.sin(np.radians(angle))
    rot = np.array([[c, s], [-s, c]])
    pts = np.array(
        [[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]]
    )
    return np.array([cx, cy]) + pts @ rot


def rotated_iou_matrix(dts: np.ndarray, gts: np.ndarray,
                       crowd: Optional[np.ndarray] = None) -> np.ndarray:
    """Exact polygon IoU between rotated boxes (D, 5) x (G, 5) -> (D, G).

    ``iscrowd`` gts use intersection over detection area (see
    ``bbox_iou_matrix``)."""
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    d_polys = [_rotated_to_polygon(d) for d in dts]
    g_polys = [_rotated_to_polygon(g) for g in gts]
    d_areas = [_polygon_area(p) for p in d_polys]
    g_areas = [_polygon_area(p) for p in g_polys]
    out = np.zeros((len(dts), len(gts)))
    for i, dp in enumerate(d_polys):
        for j, gp in enumerate(g_polys):
            inter = _polygon_area(_clip_polygon(dp, gp))
            if crowd is not None and crowd[j]:
                union = d_areas[i]
            else:
                union = d_areas[i] + g_areas[j] - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


def greedy_match(iou: np.ndarray, gt_ig: np.ndarray, gt_crowd: np.ndarray,
                 thrs: Sequence[float], dt_out: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """COCO's greedy matching of one (image, category) cell at each of
    ``thrs`` (pycocotools' evaluateImg): ``iou`` (D, G) with the ground
    truths ordered non-ignored first, their ignore and crowd flags, and the
    detections' out-of-area-range flags. Returns ``(dtm, dt_ignore)``,
    (T, D) int64 and bool."""
    T, (D, G) = len(thrs), iou.shape
    dtm = np.zeros((T, D), dtype=np.int64)
    gtm = np.zeros((T, G), dtype=np.int64)
    dt_ig = np.zeros((T, D), dtype=bool)
    for ti, t in enumerate(thrs):
        for di in range(D):
            best = min(t, 1 - 1e-10)
            match = -1
            for gi in range(G):
                if gtm[ti, gi] > 0 and not gt_crowd[gi]:
                    continue
                # stop at ignored gts once a non-ignored match found
                if match > -1 and not gt_ig[match] and gt_ig[gi]:
                    break
                if iou[di, gi] < best:
                    continue
                best = iou[di, gi]
                match = gi
            if match == -1:
                continue
            dt_ig[ti, di] = gt_ig[match]
            dtm[ti, di] = 1
            gtm[ti, match] = 1
    dt_ig = np.logical_or(dt_ig, np.logical_and(dtm == 0, dt_out[None, :]))
    return dtm, dt_ig


class COCOEval:
    """Greedy-matching COCO evaluation over in-memory annotation lists.

    Annotations are dicts: detections ``{image_id, category_id, bbox, score,
    area}``, ground truth ``{image_id, category_id, bbox, area, iscrowd}``.
    ``bbox`` is x1y1x2y2 for axis-aligned mode or (cx, cy, w, h, angle) for
    rotated mode.
    """

    def __init__(self, gt_annos: List[Dict], dt_annos: List[Dict],
                 rotated: bool = False):
        self.rotated = rotated
        self.gts = defaultdict(list)
        self.dts = defaultdict(list)
        img_ids = set()
        cat_ids = set()
        for g in gt_annos:
            self.gts[(g["image_id"], g["category_id"])].append(g)
            img_ids.add(g["image_id"])
            cat_ids.add(g["category_id"])
        for d in dt_annos:
            self.dts[(d["image_id"], d["category_id"])].append(d)
            img_ids.add(d["image_id"])
            cat_ids.add(d["category_id"])
        self.img_ids = sorted(img_ids)
        self.cat_ids = sorted(cat_ids)
        self.eval: Dict[str, np.ndarray] = {}
        self._match = (native.coco_greedy_match if native.enabled()
                       else greedy_match)

    # ------------------------------------------------------------------
    def _iou(self, img_id, cat_id) -> np.ndarray:
        gts = self.gts[(img_id, cat_id)]
        dts = sorted(self.dts[(img_id, cat_id)], key=lambda d: -d["score"])
        dts = dts[: max(MAX_DETS)]
        if not gts or not dts:
            return np.zeros((len(dts), len(gts)))
        d = np.array([dt["bbox"] for dt in dts])
        g = np.array([gt["bbox"] for gt in gts])
        crowd = np.array([bool(gt.get("iscrowd", 0)) for gt in gts])
        if self.rotated:
            return rotated_iou_matrix(d, g, crowd)
        return bbox_iou_matrix(d, g, crowd)

    def _evaluate_img(self, img_id, cat_id, area_rng, max_det, ious):
        gts = self.gts[(img_id, cat_id)]
        dts = sorted(self.dts[(img_id, cat_id)], key=lambda d: -d["score"])
        dts = dts[:max_det]
        if not gts and not dts:
            return None

        gt_ig = np.array(
            [
                bool(g.get("iscrowd", 0))
                or g["area"] < area_rng[0]
                or g["area"] > area_rng[1]
                for g in gts
            ],
            dtype=bool,
        )
        # non-ignored gts first (stable), mirrors pycocotools gtind sort
        gt_order = np.argsort(gt_ig, kind="mergesort")
        gt_ig = gt_ig[gt_order]
        iou = ious[:, gt_order] if len(gts) else ious

        D = len(dts)
        G = len(gts)
        dt_out = np.array(
            [d["area"] < area_rng[0] or d["area"] > area_rng[1] for d in dts],
            dtype=bool,
        )
        gt_crowd = np.array(
            [bool(gts[gt_order[gi]].get("iscrowd", 0)) for gi in range(G)],
            dtype=bool,
        )
        # the cached IoU matrix covers the top max(MAX_DETS) detections
        dtm, dt_ig = self._match(iou[:D].reshape(D, G), gt_ig, gt_crowd,
                                 IOU_THRS, dt_out)
        return {
            "dt_scores": np.array([d["score"] for d in dts]),
            "dt_matches": dtm,
            "dt_ignore": dt_ig,
            "num_gt": int((~gt_ig).sum()),
        }

    # ------------------------------------------------------------------
    def evaluate_and_accumulate(self) -> None:
        T, R = len(IOU_THRS), len(REC_THRS)
        K, A, M = len(self.cat_ids), len(AREA_RNG), len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        for ki, cat_id in enumerate(self.cat_ids):
            iou_cache = {
                img_id: self._iou(img_id, cat_id) for img_id in self.img_ids
            }
            for ai, area_rng in enumerate(AREA_RNG):
                # match ONCE per image at MAX_DETS[-1] and slice per-image
                # detection prefixes for the smaller maxDets (pycocotools'
                # accumulate does exactly this: greedy matching of the
                # first k score-sorted detections is independent of the
                # later ones, so the prefix of the full match IS the match
                # at the smaller limit)
                full = [self._evaluate_img(img_id, cat_id, area_rng,
                                           MAX_DETS[-1], iou_cache[img_id])
                        for img_id in self.img_ids]
                full = [r for r in full if r is not None]
                for mi, max_det in enumerate(MAX_DETS):
                    results = full
                    if not results:
                        continue

                    scores = np.concatenate(
                        [r["dt_scores"][:max_det] for r in results])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate(
                        [r["dt_matches"][:, :max_det] for r in results],
                        axis=1)[:, order]
                    dt_ig = np.concatenate(
                        [r["dt_ignore"][:, :max_det] for r in results],
                        axis=1)[:, order]
                    npig = sum(r["num_gt"] for r in results)
                    if npig == 0:
                        continue

                    tps = np.logical_and(dtm > 0, ~dt_ig)
                    fps = np.logical_and(dtm == 0, ~dt_ig)
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)

                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0.0

                        # make precision monotonically decreasing
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q

        self.eval = {"precision": precision, "recall": recall}

    # ------------------------------------------------------------------
    def summarize(
        self,
        ap: bool = True,
        iou_thresh: Optional[float] = None,
        area_range: str = "all",
        max_detection: int = 100,
    ) -> Tuple[np.ndarray, float]:
        """Per-class metric vector + mean, matching the reference's
        ``Evaluator.__summarize`` (evaluation/coco.py:357-386)."""
        a_idx = AREA_LBL.index(area_range)
        m_idx = MAX_DETS.index(max_detection)
        if ap:
            val = self.eval["precision"].copy()  # (T, R, K, A, M)
            if iou_thresh is not None:
                t_sel = np.isclose(IOU_THRS, iou_thresh)
                val = val[t_sel]
            val = val[:, :, :, a_idx, m_idx]
        else:
            val = self.eval["recall"].copy()  # (T, K, A, M)
            if iou_thresh is not None:
                t_sel = np.isclose(IOU_THRS, iou_thresh)
                val = val[t_sel]
            val = val[:, :, a_idx, m_idx]

        val[val == -1] = np.nan
        val = val.reshape((-1, val.shape[-1]))
        valid = np.any(~np.isnan(val), axis=0)
        cls_val = np.nan * np.ones(len(valid), dtype=np.float64)
        if np.any(valid):
            cls_val[valid] = np.nanmean(val[:, valid], axis=0)
            mean_val = float(np.nanmean(cls_val))
        else:
            mean_val = float("nan")
        return cls_val, mean_val
