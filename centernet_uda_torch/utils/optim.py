"""Optimizer and per-epoch LR schedule (torch-name compatible configs).

Counterpart of ``centernet_uda_tpu/utils/optim.py`` for the baseline's
optimizer: ``Adam`` is ``torch.optim.Adam(weight_decay=...)``, whose weight
decay is coupled L2 (added to the gradient before the moments), the same
as the JAX package's ``add_decayed_weights`` + ``adam`` chain. Schedulers
step per epoch: ``MultiStepLR.lr(epoch, base_lr)`` is a host-side function
and ``set_learning_rate`` writes the result into the param groups. The
other optimizers and schedulers are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Sequence

import torch


def make_optimizer(name: str, params: Optional[Dict[str, Any]],
                   parameters: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Optimizer:
    """Build an optimizer from the YAML ``optimizer`` section."""
    if name != "Adam":
        raise KeyError(f"optimizer '{name}' is not ported yet; available: "
                       "['Adam']")
    kwargs = dict(params or {})
    lr = float(kwargs.pop("lr", 1e-3))
    betas = tuple(kwargs.pop("betas", (0.9, 0.999)))
    eps = float(kwargs.pop("eps", 1e-8))
    weight_decay = float(kwargs.pop("weight_decay", 0.0))
    return torch.optim.Adam(parameters, lr=lr, betas=betas, eps=eps,
                            weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


class MultiStepLR:
    """lr = base_lr * gamma ** (number of milestones <= epoch)."""

    def __init__(self, milestones: Sequence[int], gamma: float = 0.1, **_):
        self.milestones = sorted(int(m) for m in milestones)
        self.gamma = float(gamma)

    def lr(self, epoch: int, base_lr: float) -> float:
        passed = sum(1 for m in self.milestones if epoch >= m)
        return base_lr * self.gamma ** passed


_SCHEDULERS = {"MultiStepLR": MultiStepLR}


def make_scheduler(name: Optional[str],
                   params: Optional[Dict[str, Any]] = None):
    if name is None:
        return None
    if name not in _SCHEDULERS:
        raise KeyError(f"scheduler '{name}' is not ported yet; available: "
                       f"{sorted(_SCHEDULERS)}")
    return _SCHEDULERS[name](**dict(params or {}))
