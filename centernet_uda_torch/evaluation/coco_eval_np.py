"""Pure-numpy COCO detection evaluation (COCOeval-equivalent).

The protocol of ``centernet_uda_tpu/evaluation/coco_eval_np.py``. Its greedy
matcher runs in the host library (``native.coco_greedy_match``, where the
JAX evaluator calls its own C++ matcher), or, with
``CENTERNET_DISABLE_NATIVE`` set, in Python (``greedy_match``, its plain
version, which gives the same arrays). It re-implements the COCO mAP
protocol that the reference's ``evaluation/coco.py`` drives through
``pycocotools.cocoeval.COCOeval``: 10 IoU thresholds 0.50:0.05:0.95, 101
recall thresholds, area ranges all/small/medium/large, maxDets [1, 10, 100],
greedy score-ordered matching with ignore handling, and the
precision (T, R, K, A, M) / recall (T, K, A, M) accumulation tables.

It works on columns (``Boxes``: a numpy array a field, a row a box) and
groups each by (category, image) with one stable sort; lists of
annotation dicts become columns first.

Axis-aligned boxes use the standard corner-intersection IoU (pycocotools
``bbox`` mode). Rotated boxes use exact convex-polygon IoU
(Sutherland–Hodgman clipping) instead of the reference's rasterized
RLE-mask IoU (evaluation/coco.py:317-329) — equivalent up to rasterization
error and much faster on the host.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

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


class Boxes(NamedTuple):
    """Annotations as columns: one row a box, in the order they came.

    ``bbox`` is (N, 4) x1y1x2y2, or (N, 5) (cx, cy, w, h, angle) in rotated
    mode. ``score`` is the detections' (None for ground truth), ``iscrowd``
    the ground truth's (None: no crowd box)."""

    image_id: np.ndarray     # (N,) int64
    category_id: np.ndarray  # (N,) int64
    bbox: np.ndarray         # (N, 4 or 5) float64
    area: np.ndarray         # (N,) float64
    score: Optional[np.ndarray] = None
    iscrowd: Optional[np.ndarray] = None

    @classmethod
    def from_annos(cls, annos: Sequence[Dict], width: int,
                   scored: bool) -> "Boxes":
        """Columns of annotation dicts: detections ``{image_id,
        category_id, bbox, score, area}`` (``scored``), ground truth
        ``{image_id, category_id, bbox, area, iscrowd}``."""
        return cls(
            np.array([a["image_id"] for a in annos], np.int64),
            np.array([a["category_id"] for a in annos], np.int64),
            np.array([a["bbox"][:width] for a in annos],
                     np.float64).reshape(len(annos), width),
            np.array([a["area"] for a in annos], np.float64),
            np.array([a["score"] for a in annos], np.float64)
            if scored else None,
            None if scored else np.array(
                [bool(a.get("iscrowd", 0)) for a in annos], bool))

    @classmethod
    def concatenate(cls, parts: Sequence["Boxes"], width: int,
                    scored: bool) -> "Boxes":
        """The rows of ``parts`` in order (none, boxes ``width`` wide, when
        there is no part)."""
        if not parts:
            return cls.from_annos([], width, scored)
        return cls(*(None if column[0] is None else np.concatenate(column)
                     for column in zip(*parts)))


class COCOEval:
    """Greedy-matching COCO evaluation over in-memory annotations.

    ``gts`` and ``dts`` are ``Boxes``, or lists of annotation dicts (see
    ``Boxes.from_annos``), which become ``Boxes`` first. Each is grouped by
    (category, image) with one stable sort: the ground truth of a cell in
    the order it came, its detections by score, highest first, ties in the
    order they came (as pycocotools' sort by score leaves them).
    """

    def __init__(self, gts, dts, rotated: bool = False):
        width = 5 if rotated else 4
        if not isinstance(gts, Boxes):
            gts = Boxes.from_annos(gts, width, scored=False)
        if not isinstance(dts, Boxes):
            dts = Boxes.from_annos(dts, width, scored=True)
        gts = gts._replace(iscrowd=np.zeros(len(gts.area), bool)
                           if gts.iscrowd is None
                           else np.asarray(gts.iscrowd, bool))
        self.rotated = rotated
        img_ids = np.unique(np.concatenate([gts.image_id, dts.image_id]))
        cat_ids = np.unique(np.concatenate([gts.category_id,
                                            dts.category_id]))
        self.img_ids = img_ids.tolist()
        self.cat_ids = cat_ids.tolist()

        # a cell is (category, image): category-major, so that a
        # category's cells lie together, in the order of their images
        def cells(boxes):
            return (np.searchsorted(cat_ids, boxes.category_id) * len(img_ids)
                    + np.searchsorted(img_ids, boxes.image_id))

        g_cell, d_cell = cells(gts), cells(dts)
        g_order = np.argsort(g_cell, kind="stable")
        d_order = np.lexsort((-dts.score, d_cell))
        self.gts = Boxes(*(None if c is None else c[g_order] for c in gts))
        self.dts = Boxes(*(None if c is None else c[d_order] for c in dts))
        self._g_cell = g_cell[g_order]
        # rows [start[c], start[c + 1]) are cell c's
        edges = np.arange(len(cat_ids) * len(img_ids) + 1)
        self._g_start = np.searchsorted(self._g_cell, edges)
        self._d_start = np.searchsorted(d_cell[d_order], edges)
        self.eval: Dict[str, np.ndarray] = {}
        self._match = (native.coco_greedy_match if native.enabled()
                       else greedy_match)

    # ------------------------------------------------------------------
    def evaluate_and_accumulate(self) -> None:
        T, R = len(IOU_THRS), len(REC_THRS)
        K, A, M = len(self.cat_ids), len(AREA_RNG), len(MAX_DETS)
        I = len(self.img_ids)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        gts, dts = self.gts, self.dts
        g_start, d_start = self._g_start, self._d_start
        num_g = np.diff(g_start)
        # each cell's top max(MAX_DETS) detections by score: ``kept`` in
        # cell order, ``rank`` each one's place in its cell
        num_d = np.minimum(np.diff(d_start), MAX_DETS[-1])
        k_start = np.concatenate([[0], np.cumsum(num_d)])
        rank = (np.arange(len(dts.area))
                - np.repeat(d_start[:-1], np.diff(d_start)))
        kept = np.flatnonzero(rank < MAX_DETS[-1])
        rank = rank[kept]
        iscrowd = gts.iscrowd
        iou_fn = rotated_iou_matrix if self.rotated else bbox_iou_matrix
        d_area = dts.area[kept]
        areas = []
        for lo, hi in AREA_RNG:
            gt_ig = iscrowd | (gts.area < lo) | (gts.area > hi)
            # each cell's non-ignored gts first (stable), mirrors
            # pycocotools' gtind sort
            areas.append((gt_ig, np.lexsort((gt_ig, self._g_cell)),
                          (d_area < lo) | (d_area > hi)))

        for ki in range(K):
            first, last = ki * I, (ki + 1) * I
            dk = slice(k_start[first], k_start[last])
            gk = slice(g_start[first], g_start[last])
            # only cells with both ground truth and detections need the
            # matcher: elsewhere no detection matches, and the ground
            # truth counts in the recall's denominator alone
            matched = first + np.flatnonzero(
                (num_g[first:last] > 0) & (num_d[first:last] > 0))
            ious = [iou_fn(dts.bbox[d_start[c]:d_start[c] + num_d[c]],
                           gts.bbox[g_start[c]:g_start[c + 1]],
                           iscrowd[g_start[c]:g_start[c + 1]])
                    for c in matched]
            scores, ranks = dts.score[kept[dk]], rank[dk]

            for ai, (gt_ig, g_order, d_out) in enumerate(areas):
                dt_out = d_out[dk]
                dtm = np.zeros((T, len(dt_out)), np.int64)
                dt_ig = np.repeat(dt_out[None], T, axis=0)
                for c, iou in zip(matched, ious):
                    order = g_order[g_start[c]:g_start[c + 1]]
                    cols = slice(k_start[c] - dk.start,
                                 k_start[c] - dk.start + num_d[c])
                    dtm[:, cols], dt_ig[:, cols] = self._match(
                        iou[:, order - g_start[c]], gt_ig[order],
                        iscrowd[order], IOU_THRS, dt_out[cols])
                npig = int((~gt_ig[gk]).sum())
                if npig == 0:
                    continue
                for mi, max_det in enumerate(MAX_DETS):
                    # each cell's first max_det of the match at
                    # MAX_DETS[-1]: greedy matching of the first k
                    # detections does not depend on the later ones (as
                    # pycocotools' accumulate slices it); cells in image
                    # order, then by score (stable)
                    sel = ranks < max_det
                    order = np.argsort(-scores[sel], kind="mergesort")
                    tps = np.logical_and(dtm[:, sel] > 0, ~dt_ig[:, sel])
                    fps = np.logical_and(dtm[:, sel] == 0, ~dt_ig[:, sel])
                    tp = np.cumsum(tps[:, order], axis=1).astype(np.float64)
                    fp = np.cumsum(fps[:, order], axis=1).astype(np.float64)
                    rc = tp / npig
                    pr = tp / np.maximum(tp + fp, np.spacing(1))
                    n = rc.shape[1]
                    if not n:
                        recall[:, ki, ai, mi] = 0.0
                        precision[:, :, ki, ai, mi] = 0.0
                        continue
                    recall[:, ki, ai, mi] = rc[:, -1]
                    # make precision monotonically decreasing
                    pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
                    for ti in range(T):
                        inds = np.searchsorted(rc[ti], REC_THRS, side="left")
                        precision[ti, :, ki, ai, mi] = np.where(
                            inds < n, pr[ti, np.minimum(inds, n - 1)], 0.0)

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
