"""Adversarial (ADVENT) discriminator loss.

Counterpart of ``centernet_uda_tpu/losses/advent.py`` (the reference's
``losses/advent.py:5-18``): the mean binary cross-entropy with logits of
the discriminator's output against a constant domain label (source 0,
target 1), in float32. Across ranks the mean is the global batch's, and
the loss this rank's share (``parallel/ddp.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from centernet_uda_torch.parallel.ddp import rank_share


@dataclass
class AdventLoss:
    def __call__(self, y_pred: torch.Tensor, y_true: float
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits = y_pred.float()
        loss = rank_share(F.binary_cross_entropy_with_logits(
            logits, torch.full_like(logits, float(y_true))))
        return loss, {"advent_loss": loss}
