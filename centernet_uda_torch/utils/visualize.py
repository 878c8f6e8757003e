"""Detection visualization: a copy of ``centernet_uda_tpu/utils/visualize.py``
(the reference's utils/visualize.py), OpenCV imported where it draws.

Denormalizes an HWC input image and draws predictions | ground truth side
by side: axis-aligned boxes as rectangles, rotated boxes as polygons
(utils/visualize.py:84-147), keypoints as dots, one color per class from a
rainbow map (utils/visualize.py:19-21).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from centernet_uda_torch.data.box import rotate_bbox_float


def _rainbow_colors(n: int):
    import cv2

    colors = []
    for i in range(max(n, 1)):
        hue = int(179 * i / max(n, 1))
        bgr = cv2.cvtColor(
            np.array([[[hue, 255, 255]]], np.uint8), cv2.COLOR_HSV2RGB
        )[0, 0]
        colors.append(tuple(int(c) for c in bgr))
    return colors


class Visualizer:
    def __init__(self, classes: Optional[Dict] = None, mean=None, std=None,
                 score_threshold: float = 0.2, num_classes: int = 80):
        self.classes = classes or {}
        n = len(self.classes) or num_classes
        self.colors = _rainbow_colors(n)
        self.mean = np.array(
            mean if mean is not None else (0.40789654, 0.44719302, 0.47026115),
            np.float32,
        )
        self.std = np.array(
            std if std is not None else (0.28863828, 0.27408164, 0.27809835),
            np.float32,
        )
        self.score_threshold = score_threshold

    def denormalize(self, image: np.ndarray) -> np.ndarray:
        img = (image * self.std + self.mean) * 255.0
        return np.clip(img, 0, 255).astype(np.uint8)

    def _draw(self, canvas, boxes, classes, scores=None, rotated=False,
              kps=None):
        import cv2

        for i in range(len(boxes)):
            if scores is not None and scores[i] < self.score_threshold:
                continue
            cls_id = int(classes[i])
            color = self.colors[cls_id % len(self.colors)]
            if rotated:
                pts = rotate_bbox_float(*boxes[i][:5]).astype(np.int32)
                cv2.polylines(canvas, [pts.reshape(-1, 1, 2)], True, color, 2)
            else:
                x1, y1, x2, y2 = [int(v) for v in boxes[i][:4]]
                cv2.rectangle(canvas, (x1, y1), (x2, y2), color, 2)
            if kps is not None:
                for p in np.asarray(kps[i]).reshape(-1, 2):
                    cv2.circle(canvas, (int(p[0]), int(p[1])), 3, color, -1)
        return canvas

    def visualize_detections(
        self, image, pred_boxes, pred_classes, pred_scores,
        gt_boxes, gt_classes, rotated=False, pred_kps=None, gt_kps=None,
    ) -> np.ndarray:
        img = self.denormalize(np.asarray(image))
        pred_canvas = self._draw(
            img.copy(), pred_boxes, pred_classes, pred_scores, rotated, pred_kps
        )
        gt_canvas = self._draw(
            img.copy(), gt_boxes, gt_classes, None, rotated, gt_kps
        )
        sep = np.full((img.shape[0], 4, 3), 255, np.uint8)
        return np.concatenate([pred_canvas, sep, gt_canvas], axis=1)
