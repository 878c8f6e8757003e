"""ADVENT: adversarial entropy minimization.

Counterpart of ``centernet_uda_tpu/uda/adversarial_entropy_minimization.py``
(the reference's ``uda/adversarial_entropy_minimization.py``): a 5-layer
stride-2 conv discriminator reads pixel-wise entropy maps of the heatmap
softmax; the backend is trained to fool it on target images while it
learns source (0) against target (1).

One train step computes both updates from the same pre-update state, as
the JAX package's single jitted step does:

- the backend's gradient of ``centernet(source) + adversarial_weight *
  BCE(D(entropy(target_hm)), 0)``, taken with respect to the backend's
  parameters only (D gets nothing from it);
- D's gradient of ``BCE(D(entropy(sigmoid(source_hm))), 0) / 2 +
  BCE(D(entropy(target_hm)), 1) / 2`` on detached heatmaps. The source
  heatmap is sigmoided first: the reference's ``DetectionLoss`` sigmoids it
  in place before D sees it, while the target stays raw.

Both losses exist before either optimizer steps. D has its own optimizer
(``optimizer``: the YAML section of the method; Adam at lr 1e-3 by
default) and an optional per-epoch schedule, and its checkpoint
``discriminator.ckpt`` sits next to the model's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from centernet_uda_torch.losses.advent import AdventLoss
from centernet_uda_torch.models.common import lecun_normal_
from centernet_uda_torch.ops.entropy import entropy_map
from centernet_uda_torch.ops.tensor import sigmoid_clamped
from centernet_uda_torch.uda.base import Model
from centernet_uda_torch.utils import checkpoint as ckpt
from centernet_uda_torch.utils import optim as optim_util


class FCDiscriminator(nn.Sequential):
    """4 x [Conv k4 s2 p1, LeakyReLU 0.2] (ndf, 2 ndf, 4 ndf, 8 ndf), then
    Conv k4 s2 p1 to one channel; NCHW. State-dict keys ``0``, ``2``, ...,
    ``8`` as the reference's ``nn.Sequential``. Weights are flax's default
    init (LeCun normal, zero bias), drawn on the CPU from ``generator``."""

    def __init__(self, in_channels: int, ndf: int = 64,
                 generator: Optional[torch.Generator] = None):
        layers = []
        for width in (ndf, ndf * 2, ndf * 4, ndf * 8):
            layers += [nn.Conv2d(in_channels, width, 4, 2, 1),
                       nn.LeakyReLU(0.2)]
            in_channels = width
        layers.append(nn.Conv2d(in_channels, 1, 4, 2, 1))
        super().__init__(*layers)
        for conv in list(self)[0::2]:
            lecun_normal_(conv.weight, generator)
            nn.init.zeros_(conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-2] < 32 or x.shape[-1] < 32:
            # five stride-2 convs need >= 32 px (input images >= 128 px at
            # down_ratio 4)
            raise ValueError(
                f"FCDiscriminator input {x.shape[-2]}x{x.shape[-1]} is too "
                "small: five stride-2 convs need >= 32x32 (input images >= "
                "128 px at down_ratio 4)")
        return super().forward(x)


class AdversarialEntropyMinimization(Model):
    requires_target_domain = True

    SOURCE_LABEL = 0.0
    TARGET_LABEL = 1.0

    def __init__(self, adversarial_weight: float,
                 optimizer: Optional[Dict[str, Any]] = None, device="cuda"):
        super().__init__(device)
        self.adversarial_loss = AdventLoss()
        self.adversarial_weight = float(adversarial_weight)
        self.disc_optimizer_cfg = optimizer
        self.discriminator: Optional[FCDiscriminator] = None
        self.disc_optimizer: Optional[torch.optim.Optimizer] = None
        self.disc_base_lr = 0.0
        self.disc_scheduler = None

    def init_done(self):
        super().init_done()
        seed = int(self.cfg.get("seed", 42)) if self.cfg else 42
        self.discriminator = FCDiscriminator(
            self.backend.num_classes,
            generator=torch.Generator().manual_seed(seed + 1)).to(self.device)
        cfg = self.disc_optimizer_cfg
        if cfg is None:
            name, params = "Adam", {"lr": 1e-3}  # torch Adam's defaults
        else:
            name, params = cfg.get("name", "Adam"), dict(cfg.get("params")
                                                         or {})
            sched = cfg.get("scheduler")
            if sched:
                self.disc_scheduler = optim_util.make_scheduler(
                    sched.get("name"), sched.get("params", {}))
        self.disc_base_lr = float(params.get("lr", 1e-3))
        self.disc_optimizer = optim_util.make_optimizer(
            name, params, self.discriminator.parameters())

    # ------------------------------------------------------------------
    def loss_terms(self, batch, train: bool):
        """The backend's loss: the source's ``DetectionLoss`` plus the
        weighted fool loss (the target's entropy map labelled source)."""
        outputs_src, outputs_tgt = self._forward_domains(batch["input"],
                                                         batch, train)
        task_loss, stats = self.centernet_loss(outputs_src, batch)
        d_tgt = self.discriminator(entropy_map(outputs_tgt["hm"]))
        dtf_loss = (self.adversarial_loss(d_tgt, self.SOURCE_LABEL)[0]
                    * self.adversarial_weight)
        stats = {**stats, "dis_fool": dtf_loss}
        return task_loss + dtf_loss, ({"source_domain": outputs_src,
                                       "target_domain": outputs_tgt}, stats)

    def _disc_loss(self, outputs, stats) -> torch.Tensor:
        """D's loss on the detached heatmaps; its halves go into
        ``stats``."""
        src_in = sigmoid_clamped(outputs["source_domain"]["hm"].detach())
        d_src = self.discriminator(entropy_map(src_in))
        stats["dis_source"] = self.adversarial_loss(
            d_src, self.SOURCE_LABEL)[0] / 2.0
        d_tgt = self.discriminator(
            entropy_map(outputs["target_domain"]["hm"].detach()))
        stats["dis_target"] = self.adversarial_loss(
            d_tgt, self.TARGET_LABEL)[0] / 2.0
        return stats["dis_source"] + stats["dis_target"]

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        self.optimizer.zero_grad(set_to_none=True)
        self.disc_optimizer.zero_grad(set_to_none=True)
        loss, (outputs, stats) = self.loss_terms(batch, True)
        disc_loss = self._disc_loss(outputs, stats)
        loss.backward(inputs=[p for p in self.backend.module.parameters()
                              if p.requires_grad])
        disc_loss.backward(inputs=list(self.discriminator.parameters()))
        self.optimizer.step()
        self.disc_optimizer.step()
        stats = {k: v.detach() for k, v in stats.items()}
        stats["total_loss"] = (loss + disc_loss).detach()
        self._fold_clamp_stats(outputs, stats)
        return stats

    @torch.no_grad()
    def eval_step(self, batch):
        loss, (outputs, stats) = self.loss_terms(batch, False)
        stats["total_loss"] = loss + self._disc_loss(outputs, stats)
        self._fold_clamp_stats(outputs, stats)
        return outputs, stats

    # ------------------------------------------------------------------
    def epoch_end(self):
        super().epoch_end()
        if self.disc_scheduler is not None:
            optim_util.set_learning_rate(
                self.disc_optimizer,
                self.disc_scheduler.lr(self.epoch, self.disc_base_lr))

    def save_model(self, path, epoch: int, with_optimizer: bool = False):
        super().save_model(path, epoch, with_optimizer)
        ckpt.save_checkpoint(Path(path).with_name("discriminator.ckpt"),
                             self.discriminator, epoch,
                             self.disc_optimizer if with_optimizer else None)

    def load_model(self, path, resume: bool = False) -> int:
        disc_path = Path(path).with_name("discriminator.ckpt")
        if disc_path.exists():
            ckpt.load_checkpoint(disc_path, self.discriminator,
                                 self.disc_optimizer, resume=resume)
        return super().load_model(path, resume=resume)
