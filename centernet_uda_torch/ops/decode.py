"""CenterNet detection decode (NCHW heads).

Counterpart of ``centernet_uda_tpu/ops/decode.py`` (the reference's
``backends/decode.py``: ``_nms``, ``_topk``, ``decode_detection``): 3x3 peak
suppression, the two-stage per-class-then-global top-k, and the assembly of
axis-aligned or rotated boxes, with the keypoints at the peaks.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from centernet_uda_torch.ops.tensor import gather_features, sigmoid_clamped


def nms_peaks(heat: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Keep only local maxima of the heatmap (B, C, H, W): a score survives
    iff it equals the max of its ``kernel x kernel`` neighbourhood."""
    pad = (kernel - 1) // 2
    hmax = F.max_pool2d(heat, kernel, stride=1, padding=pad)
    return torch.where(hmax == heat, heat, torch.zeros_like(heat))


def top_k_peaks(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, ...]:
    """Two-stage top-k over (B, C, H, W) scores: per-class top-k over the
    plane, then a global top-k over the ``C * k`` candidates.

    Returns ``(score, inds, classes, ys, xs)``, each (B, k); ``inds`` are
    flat ``y * W + x`` indices.
    """
    b, c, h, w = scores.shape
    if k > h * w:
        raise ValueError(f"top-k {k} exceeds the {h}x{w} heatmap; lower "
                         "max_detections or raise the input size")
    topk_scores, topk_inds = torch.topk(scores.reshape(b, c, h * w), k)
    topk_ys = torch.div(topk_inds, w, rounding_mode="floor").float()
    topk_xs = (topk_inds % w).float()

    topk_score, topk_ind = torch.topk(topk_scores.reshape(b, c * k), k)
    topk_cls = torch.div(topk_ind, k, rounding_mode="floor").int()

    def flat(t):
        return torch.gather(t.reshape(b, c * k), 1, topk_ind)

    return (topk_score, flat(topk_inds), topk_cls, flat(topk_ys),
            flat(topk_xs))


def decode_detections(hm: torch.Tensor, wh: torch.Tensor,
                      reg: Optional[torch.Tensor] = None,
                      kps: Optional[torch.Tensor] = None, k: int = 100,
                      rotated: bool = False, nms_size: int = 3,
                      apply_sigmoid: bool = False
                      ) -> Union[torch.Tensor,
                                 Tuple[torch.Tensor, torch.Tensor]]:
    """Top-k detections in heatmap coordinates from ``hm`` (B, C, H, W),
    ``wh`` (B, 2 or 3, H, W) and ``reg`` (B, 2, H, W): (B, k, 6) rows
    ``[x1, y1, x2, y2, score, class]``, or with ``rotated`` (B, k, 7) rows
    ``[cx, cy, w, h, angle, score, class]`` with the angle
    ``sigmoid(raw) * 360 - 180`` degrees. With ``kps`` (B, 2P, H, W) it
    returns ``(detections, keypoints)``, the keypoints (B, k, P, 2) being
    the center-relative offsets at the peaks shifted by the centers.
    ``hm`` must be sigmoided unless ``apply_sigmoid``."""
    if apply_sigmoid:
        hm = sigmoid_clamped(hm)
    heat = nms_peaks(hm, nms_size)
    scores, inds, classes, ys, xs = top_k_peaks(heat, k)
    b = hm.shape[0]

    def at_peaks(t):
        return gather_features(t.reshape(b, t.shape[1], -1).transpose(1, 2),
                               inds)

    if reg is not None:
        reg_k = at_peaks(reg)
        xs = xs.unsqueeze(-1) + reg_k[..., 0:1]
        ys = ys.unsqueeze(-1) + reg_k[..., 1:2]
    else:
        xs = xs.unsqueeze(-1) + 0.5
        ys = ys.unsqueeze(-1) + 0.5
    wh_k = at_peaks(wh)
    if rotated:
        angle = sigmoid_clamped(wh_k[..., 2:3]) * 360.0 - 180.0
        bboxes = torch.cat([xs, ys, wh_k[..., 0:1], wh_k[..., 1:2], angle],
                           dim=2)
    else:
        bboxes = torch.cat([xs - wh_k[..., 0:1] / 2.0,
                            ys - wh_k[..., 1:2] / 2.0,
                            xs + wh_k[..., 0:1] / 2.0,
                            ys + wh_k[..., 1:2] / 2.0], dim=2)
    detections = torch.cat([bboxes, scores.unsqueeze(-1),
                            classes.unsqueeze(-1).float()], dim=2)
    if kps is None:
        return detections
    kps_k = at_peaks(kps).reshape(b, k, -1, 2)
    kps_k = kps_k + torch.stack([xs, ys], dim=-1)
    return detections, kps_k
