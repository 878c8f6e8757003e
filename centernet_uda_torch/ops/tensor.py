"""Small tensor helpers shared by the losses and decode (NCHW).

Counterparts of ``centernet_uda_tpu/ops/tensor.py`` and of the reference's
``utils/tensor.py`` (``_sigmoid``, ``_gather_feat``,
``_transpose_and_gather_feat``).
"""

from __future__ import annotations

import torch


def sigmoid_clamped(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Sigmoid clamped to [eps, 1-eps], so the focal loss never logs 0."""
    return torch.clamp(torch.sigmoid(x), eps, 1.0 - eps)


def gather_features(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """Rows of ``feat`` (B, N, C) at ``ind`` (B, K) -> (B, K, C)."""
    ind = ind.long().unsqueeze(-1).expand(-1, -1, feat.shape[-1])
    return torch.gather(feat, 1, ind)


def gather_features_nchw(feat: torch.Tensor, ind: torch.Tensor
                         ) -> torch.Tensor:
    """Per-pixel features of ``feat`` (B, C, H, W) at the flat ``y * W + x``
    indices ``ind`` (B, K) -> (B, K, C)."""
    b, c = feat.shape[:2]
    return gather_features(feat.reshape(b, c, -1).transpose(1, 2), ind)
