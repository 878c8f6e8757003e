"""Trainer assembly from a composed config.

Counterpart of ``build_trainer`` in ``centernet_uda_tpu/train.py`` for the
no-UDA, single-device case: backend, loss, optimizer and schedule through
the registries, on ``device``, at ``precision`` float32 or bfloat16. The
CLI ``main()`` and the data loaders wait for ROADMAP A6/A7.
"""

from __future__ import annotations

import torch

from centernet_uda_torch import losses as loss_registry
from centernet_uda_torch import models as model_registry
from centernet_uda_torch import resolve_device
from centernet_uda_torch.uda.base import Model
from centernet_uda_torch.utils import optim as optim_util

# the config's ``precision``: the compute dtype of the backend's layers
# (centernet_uda_tpu/train.py passes ``dtype`` to the model the same way)
PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_trainer(cfg, device="cuda") -> Model:
    """Assemble backend + loss + optimizer + trainer; call ``init_done()``
    on the result before the first step."""
    device = resolve_device(device)
    precision = str(cfg.get("precision", "float32"))
    if precision not in PRECISIONS:
        raise NotImplementedError(
            f"precision {precision!r} is not ported (only "
            f"{sorted(PRECISIONS)})")
    # float32 means float32, in both modes (bfloat16 keeps its BatchNorm,
    # loss and optimizer in float32): no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg.model.get("uda"):
        raise NotImplementedError("UDA trainers are not ported yet "
                                  "(ROADMAP A8)")
    if cfg.get("mesh") or isinstance(cfg.get("gpu"), (list, tuple)):
        raise NotImplementedError("multi-device training is not ported yet "
                                  "(ROADMAP A11)")

    backend_params = cfg.model.backend.params.to_dict()
    backend_params.setdefault("dcn_impl", str(cfg.get("dcn_impl", "auto")))
    backend_params.setdefault("dtype", PRECISIONS[precision])
    backend = model_registry.build(cfg.model.backend.name, **backend_params,
                                   seed=int(cfg.get("seed", 42)),
                                   device=device)

    trainer = Model(device=device)
    loss_cfg = cfg.model.backend.loss
    loss_params = loss_cfg.get("params")
    trainer.centernet_loss = loss_registry.build(
        loss_cfg.name, **(loss_params.to_dict() if loss_params else {}))
    trainer.cfg = cfg
    trainer.backend = backend
    trainer.optimizer_cfg = cfg.optimizer.to_dict()
    sched_cfg = cfg.optimizer.get("scheduler")
    if sched_cfg:
        trainer.scheduler = optim_util.make_scheduler(
            sched_cfg.get("name"), sched_cfg.get("params", {}))
    return trainer
