"""Pixel-wise entropy map, the ADVENT discriminator's input.

Counterpart of ``centernet_uda_tpu/ops/entropy.py`` (the reference's
``utils/image.py:121-124``) in NCHW: the per-pixel, per-class weighted
self-information ``-p * log2(p) / log2(C)`` of the softmax over the class
axis of the raw heatmap logits. It is normalised by ``log2(C)`` but not
summed over the classes: the discriminator reads the C-channel map.
"""

from __future__ import annotations

import math

import torch


def entropy_map(hm: torch.Tensor) -> torch.Tensor:
    """``hm`` (B, C, H, W) logits -> (B, C, H, W) weighted
    self-information."""
    probs = torch.softmax(hm, dim=1)
    return -(probs * torch.log2(probs + 1e-30)) / math.log2(hm.shape[1])
