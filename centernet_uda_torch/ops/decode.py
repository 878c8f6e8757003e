"""CenterNet detection decode (NCHW heads).

Counterpart of ``centernet_uda_tpu/ops/decode.py`` (the reference's
``backends/decode.py``: ``_nms``, ``_topk``, ``decode_detection``) for
axis-aligned boxes without keypoints: 3x3 peak suppression, the two-stage
per-class-then-global top-k, and the box assembly.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
                      reg: Optional[torch.Tensor] = None, k: int = 100,
                      nms_size: int = 3,
                      apply_sigmoid: bool = False) -> torch.Tensor:
    """Top-k detections (B, k, 6) ``[x1, y1, x2, y2, score, class]`` in
    heatmap coordinates from ``hm`` (B, C, H, W), ``wh`` and ``reg``
    (B, 2, H, W). ``hm`` must be sigmoided unless ``apply_sigmoid``."""
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
    bboxes = torch.cat([xs - wh_k[..., 0:1] / 2.0, ys - wh_k[..., 1:2] / 2.0,
                        xs + wh_k[..., 0:1] / 2.0, ys + wh_k[..., 1:2] / 2.0],
                       dim=2)
    return torch.cat([bboxes, scores.unsqueeze(-1),
                      classes.unsqueeze(-1).float()], dim=2)
