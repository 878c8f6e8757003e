"""Direct entropy minimization.

Counterpart of ``centernet_uda_tpu/uda/entropy_minimization.py`` (the
reference's ``uda/entropy_minimization.py``): the source forward's
``DetectionLoss`` plus ``entropy_weight`` times the normalised Shannon
entropy of the target forward's heatmap softmax, one scalar.
"""

from __future__ import annotations

from centernet_uda_torch.losses.entropy import EntropyLoss
from centernet_uda_torch.uda.base import Model


class EntropyMinimization(Model):
    requires_target_domain = True

    def __init__(self, entropy_weight: float, device="cuda",
                 graphs: bool = True):
        super().__init__(device, graphs)
        self.entropy_loss = EntropyLoss()
        self.entropy_weight = float(entropy_weight)

    def loss_terms(self, batch, train: bool):
        outputs_src, outputs_tgt = self._forward_domains(batch["input"],
                                                         batch, train)
        c_loss, c_stats = self.centernet_loss(outputs_src, batch)
        e_loss, e_stats = self.entropy_loss(outputs_tgt, batch)
        loss = c_loss + e_loss * self.entropy_weight
        return loss, ({"source_domain": outputs_src,
                       "target_domain": outputs_tgt}, {**c_stats, **e_stats})
