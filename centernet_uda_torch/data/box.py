"""Rotated-box canonicalization helpers.

A copy of ``centernet_uda_tpu/data/box.py`` (the reference's
``utils/box.py``): canonical (cx, cy, w, h, angle) with ``w < h`` and
``angle in [-90, 90)``, plus corner rotation. The reference's non-``rbbox``
fallback would crash (``np.ndarray.append`` at utils/box.py:12); here it is
implemented correctly — axis-aligned COCO boxes get angle 0 (or -90 after
the w<h swap) — and documented as a deliberate fix.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def get_annotation_with_angle(ann: Dict) -> np.ndarray:
    """Return canonical ``[cx, cy, w, h, angle_deg]`` (utils/box.py:4-38)."""
    if "rbbox" not in ann:
        x, y, w, h = [float(v) for v in ann["bbox"]]
        new_ann = np.array([x + w / 2.0, y + h / 2.0, w, h, 0.0], np.float32)
        if new_ann[2] > new_ann[3]:
            new_ann[2], new_ann[3] = new_ann[3], new_ann[2]
            new_ann[4] -= 90
    else:
        assert len(ann["rbbox"]) == 5, "Unknown bbox format"
        new_ann = np.array(ann["rbbox"], dtype=np.float32)
        if new_ann[2] > new_ann[3]:
            new_ann[2], new_ann[3] = float(new_ann[3]), float(new_ann[2])
            new_ann[4] -= 90 if new_ann[4] > 0 else -90

    if new_ann[2] == new_ann[3]:
        new_ann[3] += 1  # force w < h

    if new_ann[4] == 90:
        new_ann[4] = -90

    new_ann[4] = np.clip(new_ann[4], -90, 90 - np.finfo(np.float64).eps)

    assert new_ann[2] < new_ann[3], "width not smaller than height"
    assert -90 <= new_ann[4] < 90, f"{new_ann[4]} not in [-90, 90)"
    return new_ann


def rotate_bbox(x: float, y: float, w: float, h: float, angle: float
                ) -> List[np.ndarray]:
    """Rotate a centered box's 4 corners by ``angle`` degrees (utils/box.py:41-52).

    Returns integer corner coordinates in the reference's order
    (top-left, top-right, bottom-right, bottom-left before rotation).
    """
    c, s = np.cos(np.radians(angle)), np.sin(np.radians(angle))
    rot = np.asarray([[c, s], [-s, c]])
    pts = np.asarray(
        [[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]]
    )
    return [(np.array([x, y]) + pt @ rot).astype(int) for pt in pts]


def rotate_bbox_float(x: float, y: float, w: float, h: float, angle: float
                      ) -> np.ndarray:
    """Float-precision corner rotation (no int truncation) as a (4, 2) array."""
    c, s = np.cos(np.radians(angle)), np.sin(np.radians(angle))
    rot = np.asarray([[c, s], [-s, c]])
    pts = np.asarray(
        [[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]]
    )
    return np.array([x, y]) + pts @ rot
