"""Fourier Domain Adaptation.

Counterpart of ``centernet_uda_tpu/uda/fda.py`` (the reference's
``uda/fda.py``): the source batch takes the target batch's low-frequency
FFT amplitude (``ops.fda.fda_source_to_target``, on the device), is trained
with ``DetectionLoss`` against the source targets, and the raw target
forward adds ``entropy_weight`` times the eta-entropy loss.
"""

from __future__ import annotations

from centernet_uda_torch.losses.entropy import EntropyLoss
from centernet_uda_torch.ops.fda import fda_source_to_target
from centernet_uda_torch.uda.base import Model


class FDA(Model):
    requires_target_domain = True

    def __init__(self, entropy_weight: float, beta: float, eta: float = 1.5,
                 use_circular: bool = False, device="cuda",
                 graphs: bool = True):
        super().__init__(device, graphs)
        self.entropy_loss = EntropyLoss(eta=eta)
        self.entropy_weight = float(entropy_weight)
        self.beta = float(beta)
        self.use_circular = bool(use_circular)

    def loss_terms(self, batch, train: bool):
        mixed = fda_source_to_target(batch["input"],
                                     batch["target_domain_input"], self.beta,
                                     self.use_circular)
        outputs_src, outputs_tgt = self._forward_domains(mixed, batch, train)
        c_loss, c_stats = self.centernet_loss(outputs_src, batch)
        e_loss, e_stats = self.entropy_loss(outputs_tgt, batch)
        loss = c_loss + e_loss * self.entropy_weight
        return loss, ({"source_domain": outputs_src,
                       "target_domain": outputs_tgt}, {**c_stats, **e_stats})
