"""Entropy minimization loss.

Counterpart of ``centernet_uda_tpu/losses/entropy.py`` (the reference's
``losses/entropy.py:5-28``) in NCHW. The softmax runs over the class axis
of the raw heatmap logits, in float32. With ``eta`` set (FDA) it is the
per-pixel normalised entropy, squared, plus 1e-30, raised to ``eta``, then
the mean; without it, the Shannon entropy summed over everything and
divided by ``n * h * w * log2(C)``. Across ranks each mean (and ``n``) is
the global batch's, and the loss this rank's share (``parallel/ddp.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from centernet_uda_torch.parallel.ddp import rank_share


@dataclass
class EntropyLoss:
    eta: Optional[float] = None

    def __call__(self, outputs: Dict[str, torch.Tensor], batch=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        v = torch.softmax(outputs["hm"].float(), dim=1)
        n, c, h, w = v.shape
        plogp = v * torch.log2(v + 1e-30)
        if self.eta is not None:
            ent = -plogp.sum(dim=1) / math.log2(c)  # (N, H, W)
            loss = rank_share((ent ** 2.0 + 1e-30).pow(self.eta).mean())
        else:
            loss = rank_share(-plogp.sum() / (n * h * w * math.log2(c)))
        return loss, {"entropy_loss": loss}
