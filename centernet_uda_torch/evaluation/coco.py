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
annotation conversion is plain vectorized numpy instead of a
``multiprocessing.Pool`` (evaluation/coco.py:303-307) — the conversion is no
longer the bottleneck without pycocotools' JSON round-trip.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from centernet_uda_torch.evaluation.coco_eval_np import COCOEval

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


class Evaluator:
    """Accumulating COCO-metric evaluator (evaluation/coco.py:22-101 surface)."""

    def __init__(self, per_class: bool = True, score_threshold: float = 0.1):
        self.per_class = per_class
        self.score_threshold = float(score_threshold)
        self.classes: Optional[Dict] = None
        self.use_rotated_boxes = False
        self.num_workers: Optional[int] = None
        self.pred_annos: List[Dict] = []
        self.gt_annos: List[Dict] = []
        self.existent_labels: Dict[int, bool] = {}
        # instance-level (reference used class attrs) and O(1) per lookup
        # (the reference's list.index scan is O(N) per image)
        self._cached_ids: Dict = {}
        self._anno_id = 0

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
        """
        for i in range(len(pred_boxes)):
            gt_id = gt_ids[i]
            gt_id = gt_id.item() if hasattr(gt_id, "item") else gt_id
            image_id = self._cached_ids.setdefault(
                gt_id, len(self._cached_ids) + 1
            )

            boxes = np.asarray(pred_boxes[i], np.float64)
            classes = np.asarray(pred_classes[i]).astype(int)
            scores = np.asarray(pred_scores[i], np.float64)
            keep = scores >= self.score_threshold
            for bb, lb, sc in zip(boxes[keep], classes[keep], scores[keep]):
                self._anno_id += 1
                self.pred_annos.append(
                    self._make_anno(bb, int(lb), float(sc), image_id)
                )
                self.existent_labels[int(lb)] = True

            g_boxes = np.asarray(gt_boxes[i], np.float64)
            g_classes = np.asarray(gt_classes[i]).astype(int)
            g_areas = (
                np.asarray(gt_areas[i], np.float64)
                if gt_areas is not None
                else [None] * len(g_boxes)
            )
            for bb, lb, ar in zip(g_boxes, g_classes, g_areas):
                self._anno_id += 1
                anno = self._make_anno(bb, int(lb), None, image_id, area=ar)
                self.gt_annos.append(anno)
                self.existent_labels[int(lb)] = True

    def _make_anno(self, bb, label, score, image_id, area=None) -> Dict:
        if self.use_rotated_boxes:
            cx, cy, w, h = bb[0], bb[1], bb[2], bb[3]
            if area is None or (np.isscalar(area) and area <= 0):
                area = float(w * h)
            anno = {
                "image_id": image_id,
                "category_id": label,
                "bbox": [float(v) for v in bb[:5]],
                "area": float(area),
                "iscrowd": 0,
            }
        else:
            x1, y1, x2, y2 = [float(v) for v in bb[:4]]
            # reference rounds x/y/w/h to 2 decimals before pycocotools
            # sees them ("to make the result consistent with COCO",
            # evaluation/coco.py:342-346); mirror it so near-threshold
            # IoUs flip the same way in both pipelines
            w = round(x2 - x1, 2)
            h = round(y2 - y1, 2)
            x1, y1 = round(x1, 2), round(y1, 2)
            x2, y2 = x1 + w, y1 + h
            if area is None or (np.isscalar(area) and area <= 0):
                area = h * w
            anno = {
                "image_id": image_id,
                "category_id": label,
                "bbox": [x1, y1, x2, y2],
                "area": float(area),
                "iscrowd": 0,
            }
        if score is not None:
            anno["score"] = score
        return anno

    # ------------------------------------------------------------------
    def evaluate(self) -> Dict[str, float]:
        existent = sorted(self.existent_labels)
        results: Dict[str, object] = {}

        coco_eval = COCOEval(
            self.gt_annos, self.pred_annos, rotated=self.use_rotated_boxes
        )
        coco_eval.evaluate_and_accumulate()

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
        self.pred_annos = []
        self.gt_annos = []
        self.existent_labels = {}
        self._cached_ids = {}
        self._anno_id = 0
