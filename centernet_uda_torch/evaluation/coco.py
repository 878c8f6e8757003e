"""COCO-metric evaluator with the reference's TensorBoard key surface.

A copy of ``centernet_uda_tpu/evaluation/coco.py`` (the reference's
``evaluation/coco.py``): ``add_batch`` accumulates
prediction/ground-truth arrays, ``evaluate`` runs the (numpy) COCO protocol
and returns a dict whose keys are byte-identical to the reference's —
``MSCOCO_Precision/mAP``, ``MSCOCO_Recall/mAR100``, per-class
``MSCOCO_Class_<name>/Precision/AP`` etc. (evaluation/coco.py:32-59 mapping +
the ``(``/``)``/space/``@`` scrubbing at :200-227) — because experiment YAMLs
reference them via ``save_best_metric.name``.

Unlike the reference, the gt/id caches are instance state, not class
attributes (fixing the shared-cache quirk at evaluation/coco.py:61-62), and
the store is columnar, without a ``multiprocessing.Pool``
(evaluation/coco.py:303-307) or pycocotools' JSON round-trip: ``add_batch``
turns a batch, with whole-array numpy operations, into one ``Boxes`` of
detections and one of ground truth (image ids, category ids, boxes rounded
as the reference rounds them, areas, scores). That is a few arrays a batch
and no Python object per box, so a phase's detections leave no heap for
Python's cyclic collector to walk. ``evaluate`` hands the columns to
``COCOEval``.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from centernet_uda_torch.evaluation.coco_eval_np import Boxes, COCOEval

log = logging.getLogger(__name__)

_COCO_KEY_MAPPING = {
    "map/iou=0.50:0.95/area=all/max_dets=100": "MSCOCO_Precision/mAP",
    "map/iou=0.50/area=all/max_dets=100": "MSCOCO_Precision/mAP@.50IOU",
    "map/iou=0.75/area=all/max_dets=100": "MSCOCO_Precision/mAP@.75IOU",
    "mar/iou=0.50:0.95/area=all/max_dets=1": "MSCOCO_Recall/mAR@1",
    "mar/iou=0.50:0.95/area=all/max_dets=10": "MSCOCO_Recall/mAR@10",
    "mar/iou=0.50:0.95/area=all/max_dets=100": "MSCOCO_Recall/mAR@100",
    "map/iou=0.50:0.95/area=small/max_dets=100": "MSCOCO_Precision/mAP (small)",
    "map/iou=0.50:0.95/area=medium/max_dets=100": "MSCOCO_Precision/mAP (medium)",
    "map/iou=0.50:0.95/area=large/max_dets=100": "MSCOCO_Precision/mAP (large)",
    "mar/iou=0.50:0.95/area=small/max_dets=100": "MSCOCO_Recall/mAR@100 (small)",
    "mar/iou=0.50:0.95/area=medium/max_dets=100": "MSCOCO_Recall/mAR@100 (medium)",
    "mar/iou=0.50:0.95/area=large/max_dets=100": "MSCOCO_Recall/mAR@100 (large)",
    # per-class variants (only when per_class)
    "ap/iou=0.50:0.95/area=all/max_dets=100": "MSCOCO_Class_{}/Precision/AP",
    "ap/iou=0.50/area=all/max_dets=100": "MSCOCO_Class_{}/Precision/AP@.50IOU",
    "ap/iou=0.75/area=all/max_dets=100": "MSCOCO_Class_{}/Precision/AP@.75IOU",
    "ar/iou=0.50:0.95/area=all/max_dets=1": "MSCOCO_Class_{}/Recall/AR@1",
    "ar/iou=0.50:0.95/area=all/max_dets=10": "MSCOCO_Class_{}/Recall/AR@10",
    "ar/iou=0.50:0.95/area=all/max_dets=100": "MSCOCO_Class_{}/Recall/AR@100",
    "ap/iou=0.50:0.95/area=small/max_dets=100": "MSCOCO_Class_{}/Precision/mAP (small)",
    "ap/iou=0.50:0.95/area=medium/max_dets=100": "MSCOCO_Class_{}/Precision/mAP (medium)",
    "ap/iou=0.50:0.95/area=large/max_dets=100": "MSCOCO_Class_{}/Precision/mAP (large)",
    "ar/iou=0.50:0.95/area=small/max_dets=100": "MSCOCO_Class_{}/Recall/AR@100 (small)",
    "ar/iou=0.50:0.95/area=medium/max_dets=100": "MSCOCO_Class_{}/Recall/AR@100 (medium)",
    "ar/iou=0.50:0.95/area=large/max_dets=100": "MSCOCO_Class_{}/Recall/AR@100 (large)",
}

_SUMMARY_SPECS = {
    "ap/iou=0.50:0.95/area=all/max_dets=100": dict(ap=True, iou_thresh=None, area_range="all", max_detection=100),
    "ap/iou=0.50/area=all/max_dets=100": dict(ap=True, iou_thresh=0.5, area_range="all", max_detection=100),
    "ap/iou=0.75/area=all/max_dets=100": dict(ap=True, iou_thresh=0.75, area_range="all", max_detection=100),
    "ar/iou=0.50:0.95/area=all/max_dets=1": dict(ap=False, iou_thresh=None, area_range="all", max_detection=1),
    "ar/iou=0.50:0.95/area=all/max_dets=10": dict(ap=False, iou_thresh=None, area_range="all", max_detection=10),
    "ar/iou=0.50:0.95/area=all/max_dets=100": dict(ap=False, iou_thresh=None, area_range="all", max_detection=100),
    "ap/iou=0.50:0.95/area=small/max_dets=100": dict(ap=True, iou_thresh=None, area_range="small", max_detection=100),
    "ap/iou=0.50:0.95/area=medium/max_dets=100": dict(ap=True, iou_thresh=None, area_range="medium", max_detection=100),
    "ap/iou=0.50:0.95/area=large/max_dets=100": dict(ap=True, iou_thresh=None, area_range="large", max_detection=100),
    "ar/iou=0.50:0.95/area=small/max_dets=100": dict(ap=False, iou_thresh=None, area_range="small", max_detection=100),
    "ar/iou=0.50:0.95/area=medium/max_dets=100": dict(ap=False, iou_thresh=None, area_range="medium", max_detection=100),
    "ar/iou=0.50:0.95/area=large/max_dets=100": dict(ap=False, iou_thresh=None, area_range="large", max_detection=100),
}


def round2(values: np.ndarray) -> np.ndarray:
    """Python's ``round(v, 2)`` of every value, bit for bit, as float64.

    ``rint(100 v) / 100`` is Python's answer wherever ``100 v`` lies clear
    of a tie (x.5) by more than its own rounding error: rint picks the same
    whole number of hundredths, and the division gives the double nearest
    to it, as Python's decimal round trip does. Values whose ``100 v`` is
    within 1e-6 of a tie, values of 2**20 or more and those not finite take
    Python's ``round`` (a few a batch of float32 boxes: their eighths)."""
    values = np.asarray(values, np.float64)
    hundredths = values * 100.0
    out = np.rint(hundredths) / 100.0
    with np.errstate(invalid="ignore"):  # inf - inf is a nan: not clear
        clear = ((np.abs(hundredths - np.floor(hundredths) - 0.5) > 1e-6)
                 & (np.abs(values) < 2.0 ** 20))
    if not clear.all():
        near = np.flatnonzero(~clear)
        out.flat[near] = [round(v, 2) for v in values.flat[near].tolist()]
    return out


def _rows(per_image, n: int, dtype, width: Optional[int] = None):
    """The first ``n`` images' arrays of ``per_image`` as one array, rows
    in order (``width`` columns of 2-d ones), and each image's row count."""
    parts = [np.asarray(per_image[i], dtype) for i in range(n)]
    if width is not None:
        parts = [p.reshape(-1, width) if p.ndim < 2 else p[:, :width]
                 for p in parts]
    else:
        parts = [p.reshape(-1) for p in parts]
    return np.concatenate(parts), [len(p) for p in parts]


class Evaluator:
    """Accumulating COCO-metric evaluator (evaluation/coco.py:22-101 surface).

    The store is columnar: each ``add_batch`` appends one ``Boxes`` of
    detections and one of ground truth to ``detections`` and
    ``ground_truth``, numpy arrays that it owns (image ids, category ids,
    boxes, areas, scores), and makes no Python object per box."""

    def __init__(self, per_class: bool = True, score_threshold: float = 0.1):
        self.per_class = per_class
        self.score_threshold = float(score_threshold)
        self.classes: Optional[Dict] = None
        self.use_rotated_boxes = False
        self.num_workers: Optional[int] = None
        self.detections: List[Boxes] = []
        self.ground_truth: List[Boxes] = []
        # instance-level (reference used class attrs) and O(1) per lookup
        # (the reference's list.index scan is O(N) per image)
        self._cached_ids: Dict = {}

    # ------------------------------------------------------------------
    def add_batch(
        self,
        pred_boxes,
        pred_classes,
        pred_scores,
        gt_boxes,
        gt_classes,
        gt_ids,
        gt_areas,
        image_shape=None,
        pred_kps=None,
        gt_kps=None,
    ) -> None:
        """Accumulate one batch of decoded detections + unpacked gt.

        Shapes follow ``uda.base.Model.get_detections`` (uda/base.py:125-138):
        ``pred_*`` are (B, K, ...) arrays; ``gt_*`` are per-image lists of
        variable-length arrays. Rotated boxes are 5-dim (cx, cy, w, h, deg).
        Detections below ``score_threshold`` are dropped; keypoints are
        not evaluated.
        """
        n = len(pred_boxes)
        if not n:
            return
        image_id = np.array(
            [self._cached_ids.setdefault(
                i.item() if hasattr(i, "item") else i,
                len(self._cached_ids) + 1) for i in gt_ids[:n]], np.int64)
        width = 5 if self.use_rotated_boxes else 4

        boxes, counts = _rows(pred_boxes, n, np.float64, width)
        scores = _rows(pred_scores, n, np.float64)[0]
        keep = scores >= self.score_threshold
        boxes, area = self._boxes(boxes[keep], None)
        self.detections.append(Boxes(
            np.repeat(image_id, counts)[keep],
            _rows(pred_classes, n, np.int64)[0][keep], boxes, area,
            scores[keep]))

        boxes, counts = _rows(gt_boxes, n, np.float64, width)
        given = None if gt_areas is None else \
            _rows(gt_areas, n, np.float64)[0]
        boxes, area = self._boxes(boxes, given)
        self.ground_truth.append(Boxes(
            np.repeat(image_id, counts), _rows(gt_classes, n, np.int64)[0],
            boxes, area))

    def _boxes(self, boxes: np.ndarray, area: Optional[np.ndarray]):
        """The boxes as stored, and their areas: ``area`` where it is
        given and positive, else the box's."""
        if self.use_rotated_boxes:
            own = boxes[:, 2] * boxes[:, 3]
        else:
            # reference rounds x/y/w/h to 2 decimals before pycocotools
            # sees them ("to make the result consistent with COCO",
            # evaluation/coco.py:342-346); mirror it so near-threshold
            # IoUs flip the same way in both pipelines
            x1, y1, w, h = round2(np.stack(
                [boxes[:, 0], boxes[:, 1], boxes[:, 2] - boxes[:, 0],
                 boxes[:, 3] - boxes[:, 1]]))
            boxes = np.stack([x1, y1, x1 + w, y1 + h], axis=1)
            own = h * w
        if area is not None:
            own = np.where(area <= 0, own, area)
        return boxes, own

    # ------------------------------------------------------------------
    def evaluate(self) -> Dict[str, float]:
        width = 5 if self.use_rotated_boxes else 4
        coco_eval = COCOEval(
            Boxes.concatenate(self.ground_truth, width, scored=False),
            Boxes.concatenate(self.detections, width, scored=True),
            rotated=self.use_rotated_boxes,
        )
        coco_eval.evaluate_and_accumulate()
        # every kept detection's and every gt box's category
        existent = coco_eval.cat_ids
        results: Dict[str, object] = {}

        for key, spec in _SUMMARY_SPECS.items():
            metrics, mean_metric = coco_eval.summarize(**spec)
            # metrics is indexed by coco_eval.cat_ids order; scatter to label id
            full = np.nan * np.ones(max(existent) + 1 if existent else 1)
            for ci, cat in enumerate(coco_eval.cat_ids):
                if ci < len(metrics):
                    full[cat] = metrics[ci]
            results[key] = full
            results["m" + key] = mean_metric

        results["existent_labels"] = existent
        out = self._convert_to_tensorboard(results)
        self.reset()
        return out

    def _convert_to_tensorboard(self, coco_results: Dict) -> Dict[str, float]:
        results: Dict[str, float] = {}
        for k, v in coco_results.items():
            if k not in _COCO_KEY_MAPPING:
                continue
            nk = _COCO_KEY_MAPPING[k]
            nk = (
                nk.replace("(", "").replace(")", "")
                .replace(" ", "_").replace("@", "")
            )
            if self.per_class and not k.startswith("m"):
                for cid in coco_results["existent_labels"]:
                    label = cid
                    if self.classes is not None and cid in self.classes:
                        cls_info = self.classes[cid]
                        if isinstance(cls_info, dict) and "name" in cls_info:
                            label = cls_info["name"]
                    results[nk.format(str(label))] = float(v[cid])
            elif k.startswith("m"):
                results[nk] = float(v)
        return results

    def reset(self) -> None:
        self.detections = []
        self.ground_truth = []
        self._cached_ids = {}
