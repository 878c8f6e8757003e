"""Max-squares UDA loss.

Counterpart of ``centernet_uda_tpu/losses/max_square.py`` (the reference's
``losses/max_square.py:5-14``) in NCHW: ``-mean(softmax(hm)^2) / 2`` with
the softmax over the class axis of the raw heatmap logits, in float32.
Across ranks the mean is the global batch's, and the loss this rank's share
(``parallel/ddp.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from centernet_uda_torch.parallel.ddp import rank_share


@dataclass
class MaxSquareLoss:
    def __call__(self, outputs: Dict[str, torch.Tensor], batch=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        v = torch.softmax(outputs["hm"].float(), dim=1)
        loss = -rank_share((v ** 2).mean()) / 2.0
        return loss, {"max_square_loss": loss}
