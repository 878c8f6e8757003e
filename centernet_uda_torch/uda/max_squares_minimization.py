"""Max-squares minimization.

Counterpart of ``centernet_uda_tpu/uda/max_squares_minimization.py`` (the
reference's ``uda/max_squares_minimization.py``): the source forward's
``DetectionLoss`` plus ``max_squares_weight`` times
``-mean(softmax(hm)^2)/2`` of the target forward, one scalar.
"""

from __future__ import annotations

from centernet_uda_torch.losses.max_square import MaxSquareLoss
from centernet_uda_torch.uda.base import Model


class MaxSquaresMinimization(Model):
    requires_target_domain = True

    def __init__(self, max_squares_weight: float, device="cuda",
                 graphs: bool = True):
        super().__init__(device, graphs)
        self.max_squares_loss = MaxSquareLoss()
        self.max_squares_weight = float(max_squares_weight)

    def loss_terms(self, batch, train: bool):
        outputs_src, outputs_tgt = self._forward_domains(batch["input"],
                                                         batch, train)
        s_loss, s_stats = self.centernet_loss(outputs_src, batch)
        t_loss, t_stats = self.max_squares_loss(outputs_tgt, batch)
        loss = s_loss + t_loss * self.max_squares_weight
        return loss, ({"source_domain": outputs_src,
                       "target_domain": outputs_tgt}, {**s_stats, **t_stats})
