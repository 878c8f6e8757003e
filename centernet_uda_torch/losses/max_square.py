"""Max-squares UDA loss.

Counterpart of ``centernet_uda_tpu/losses/max_square.py`` (the reference's
``losses/max_square.py:5-14``) in NCHW: ``-mean(softmax(hm)^2) / 2`` with
the softmax over the class axis of the raw heatmap logits, in float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass
class MaxSquareLoss:
    def __call__(self, outputs: Dict[str, torch.Tensor], batch=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        v = torch.softmax(outputs["hm"].float(), dim=1)
        loss = -(v ** 2).mean() / 2.0
        return loss, {"max_square_loss": loss}
