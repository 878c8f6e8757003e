"""Optimizers and per-epoch LR schedules (torch-name compatible configs).

Counterpart of ``centernet_uda_tpu/utils/optim.py``, whose optax chains
fix the arithmetic each name means here:

- ``Adam``: ``torch.optim.Adam(weight_decay=...)``, coupled L2 (added to
  the gradient before the moments), as the JAX package's
  ``add_decayed_weights`` + ``adam`` chain;
- ``AdamW``: ``torch.optim.AdamW``, decoupled decay scaled by the learning
  rate, as ``optax.adamw`` (default ``weight_decay`` 0.01, as there);
- ``SGD``: ``torch.optim.SGD`` with momentum, nesterov and coupled weight
  decay, as ``add_decayed_weights`` + ``optax.sgd``;
- ``RMSprop``: ``RMSprop`` below, optax's ``rmsprop`` as the JAX package
  builds it: ε inside the square root (g/√(ν+ε), where
  ``torch.optim.RMSprop`` takes g/(√ν+ε)), the momentum trace over steps
  already scaled by the learning rate, and ``weight_decay`` dropped (the
  JAX package's ``_rmsprop`` takes it into ``**_``; logged once).

Schedulers step per epoch: ``<Scheduler>.lr(epoch, base_lr)`` is a
host-side function and ``set_learning_rate`` writes the result into the
param groups. Unknown names raise ``KeyError``.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import torch

log = logging.getLogger(__name__)


class RMSprop(torch.optim.Optimizer):
    """optax's ``rmsprop(lr, decay=alpha, eps, momentum)``:
    ν ← α·ν + (1−α)·g², u = lr·g/√(ν+ε); with momentum, b ← μ·b + u and
    the step is b; p ← p − step."""

    def __init__(self, params, lr: float = 1e-2, alpha: float = 0.99,
                 eps: float = 1e-8, momentum: float = 0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps,
                                      momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            alpha, eps, mu = group["alpha"], group["eps"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    if mu:
                        state["trace"] = torch.zeros_like(p)
                g = p.grad
                nu = state["nu"]
                nu.mul_(alpha).add_(g * g, alpha=1.0 - alpha)
                update = g * torch.rsqrt(nu + eps) * group["lr"]
                if mu:
                    update = state["trace"].mul_(mu).add_(update)
                p.sub_(update)
        return None


def _adam(parameters, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
          **_):
    return torch.optim.Adam(parameters, lr=lr, betas=tuple(betas), eps=eps,
                            weight_decay=weight_decay)


def _adamw(parameters, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
           **_):
    return torch.optim.AdamW(parameters, lr=lr, betas=tuple(betas), eps=eps,
                             weight_decay=weight_decay)


def _sgd(parameters, lr, momentum=0.0, weight_decay=0.0, nesterov=False,
         **_):
    return torch.optim.SGD(parameters, lr=lr, momentum=momentum,
                           weight_decay=weight_decay, nesterov=nesterov)


_RMSPROP_DECAY_WARNED = False


def _rmsprop(parameters, lr, alpha=0.99, eps=1e-8, momentum=0.0, **rest):
    global _RMSPROP_DECAY_WARNED
    if rest.get("weight_decay") and not _RMSPROP_DECAY_WARNED:
        _RMSPROP_DECAY_WARNED = True
        log.warning("RMSprop ignores weight_decay=%s, as the JAX package "
                    "does", rest["weight_decay"])
    return RMSprop(parameters, lr=lr, alpha=alpha, eps=eps,
                   momentum=momentum)


_OPTIMIZERS: Dict[str, Callable[..., torch.optim.Optimizer]] = {
    "Adam": _adam, "AdamW": _adamw, "SGD": _sgd, "RMSprop": _rmsprop}


def make_optimizer(name: str, params: Optional[Dict[str, Any]],
                   parameters: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Optimizer:
    """Build an optimizer from the YAML ``optimizer`` section (``params``
    as in torch: ``lr``, ``betas``, ``eps``, ``weight_decay``, ...)."""
    if name not in _OPTIMIZERS:
        raise KeyError(f"unknown optimizer '{name}'; available: "
                       f"{sorted(_OPTIMIZERS)}")
    kwargs = {k: (float(v) if k in ("lr", "eps", "weight_decay", "alpha",
                                    "momentum") else v)
              for k, v in dict(params or {}).items()}
    lr = kwargs.pop("lr", 1e-3)
    return _OPTIMIZERS[name](parameters, lr, **kwargs)


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


class StepLR:
    """lr = base_lr * gamma ** (epoch // step_size)."""

    def __init__(self, step_size: int, gamma: float = 0.1, **_):
        self.step_size = int(step_size)
        self.gamma = float(gamma)

    def lr(self, epoch: int, base_lr: float) -> float:
        return base_lr * self.gamma ** (epoch // self.step_size)


class ExponentialLR:
    """lr = base_lr * gamma ** epoch."""

    def __init__(self, gamma: float, **_):
        self.gamma = float(gamma)

    def lr(self, epoch: int, base_lr: float) -> float:
        return base_lr * self.gamma ** epoch


class CosineAnnealingLR:
    """The closed form of torch's CosineAnnealingLR:
    ``eta_min + (base_lr - eta_min) * (1 + cos(pi * epoch / T_max)) / 2``,
    with ``eta_min`` an absolute floor, not clamped at ``T_max`` (the
    cosine goes on with period 2 T_max, as torch's recursion does)."""

    def __init__(self, T_max: int, eta_min: float = 0.0, **_):
        self.t_max = int(T_max)
        self.eta_min = float(eta_min)

    def lr(self, epoch: int, base_lr: float) -> float:
        cos = (1 + math.cos(math.pi * epoch / self.t_max)) / 2
        return self.eta_min + (base_lr - self.eta_min) * cos


_SCHEDULERS = {"MultiStepLR": MultiStepLR, "StepLR": StepLR,
               "ExponentialLR": ExponentialLR,
               "CosineAnnealingLR": CosineAnnealingLR}


def make_scheduler(name: Optional[str],
                   params: Optional[Dict[str, Any]] = None):
    if name is None:
        return None
    if name not in _SCHEDULERS:
        raise KeyError(f"unknown scheduler '{name}'; available: "
                       f"{sorted(_SCHEDULERS)}")
    return _SCHEDULERS[name](**dict(params or {}))
