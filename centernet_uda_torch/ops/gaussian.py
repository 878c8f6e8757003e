"""Gaussian target encoding for CenterNet heatmaps (numpy, host side).

Copies of ``centernet_uda_tpu/ops/gaussian.py``'s ``gaussian_radius``,
``gaussian_2d`` and ``draw_gaussian`` (the reference's ``utils/image.py``
``gaussian_radius``, ``gaussian2D`` and ``draw_umich_gaussian``).
"""

from __future__ import annotations

import math

import numpy as np


def gaussian_radius(det_size, min_overlap: float = 0.7) -> float:
    """CornerNet's three-case minimum gaussian radius."""
    height, width = det_size

    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    sq1 = math.sqrt(max(b1 ** 2 - 4 * a1 * c1, 0.0))
    r1 = (b1 + sq1) / 2.0

    a2 = 4.0
    b2 = 2.0 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = math.sqrt(max(b2 ** 2 - 4 * a2 * c2, 0.0))
    r2 = (b2 + sq2) / 2.0

    a3 = 4.0 * min_overlap
    b3 = -2.0 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = math.sqrt(max(b3 ** 2 - 4 * a3 * c3, 0.0))
    r3 = (b3 + sq3) / 2.0
    return min(r1, r2, r3)


def gaussian_2d(shape, sigma: float = 1.0) -> np.ndarray:
    """Unnormalized 2D gaussian patch."""
    m, n = [(ss - 1.0) / 2.0 for ss in shape]
    y, x = np.ogrid[-m: m + 1, -n: n + 1]
    h = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h


def draw_gaussian(heatmap: np.ndarray, center, radius: int,
                  k: float = 1.0) -> np.ndarray:
    """Max-composite a truncated gaussian into ``heatmap`` (H, W) in place:
    diameter ``2*radius+1``, ``sigma = diameter / 6``, clipped at the
    border."""
    diameter = 2 * radius + 1
    gaussian = gaussian_2d((diameter, diameter), sigma=diameter / 6)

    x, y = int(center[0]), int(center[1])
    height, width = heatmap.shape[0:2]

    left, right = min(x, radius), min(width - x, radius + 1)
    top, bottom = min(y, radius), min(height - y, radius + 1)

    masked_heatmap = heatmap[y - top: y + bottom, x - left: x + right]
    masked_gaussian = gaussian[
        radius - top: radius + bottom, radius - left: radius + right
    ]
    if min(masked_gaussian.shape) > 0 and min(masked_heatmap.shape) > 0:
        np.maximum(masked_heatmap, masked_gaussian * k, out=masked_heatmap)
    return heatmap


def encode_targets(boxes: np.ndarray, classes, out_h: int, out_w: int,
                   num_classes: int, max_detections: int) -> dict:
    """CenterNet targets of one image, as ``data/coco.py`` encodes them for
    axis-aligned boxes without keypoints.

    ``boxes`` (N, 4) are ``[x1, y1, x2, y2]`` already in output-map pixels
    (input pixels / down_ratio). Returns ``hm`` (C, out_h, out_w), ``wh`` and
    ``reg`` (K, 2), ``ind`` (K,) int64 ``y * out_w + x``, ``reg_mask`` (K,)
    uint8, ``gt_dets`` (K, 6) ``[x1, y1, x2, y2, 1, class]`` and ``gt_areas``
    (K,), with K = ``max_detections``.
    """
    k_max = max_detections
    t = {
        "hm": np.zeros((num_classes, out_h, out_w), np.float32),
        "wh": np.zeros((k_max, 2), np.float32),
        "reg": np.zeros((k_max, 2), np.float32),
        "ind": np.zeros((k_max,), np.int64),
        "reg_mask": np.zeros((k_max,), np.uint8),
        "gt_dets": np.zeros((k_max, 6), np.float32),
        "gt_areas": np.zeros((k_max,), np.float32),
    }
    for k, (box, cls_id) in enumerate(zip(boxes[:k_max], classes)):
        bbox = np.array(box, np.float32)
        bbox[[0, 2]] = np.clip(bbox[[0, 2]], 0, out_w - 1)
        bbox[[1, 3]] = np.clip(bbox[[1, 3]], 0, out_h - 1)
        h, w = bbox[3] - bbox[1], bbox[2] - bbox[0]
        if h <= 0 or w <= 0:
            continue
        radius = max(0, int(gaussian_radius((np.ceil(h), np.ceil(w)))))
        ct = np.array([(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2],
                      np.float32)
        ct_int = ct.astype(np.int32)
        draw_gaussian(t["hm"][int(cls_id)], ct_int, radius)
        t["wh"][k] = w, h
        t["ind"][k] = ct_int[1] * out_w + ct_int[0]
        t["reg"][k] = ct - ct_int
        t["reg_mask"][k] = 1
        t["gt_dets"][k] = (ct[0] - w / 2, ct[1] - h / 2, ct[0] + w / 2,
                           ct[1] + h / 2, 1, int(cls_id))
        t["gt_areas"][k] = w * h
    return t
