"""Checkpoint save/load with the reference's last/best semantics.

The semantics of ``centernet_uda_tpu/utils/checkpoint.py`` (the reference's
``utils/helper.py:83-147``) in the reference's own format: a checkpoint is
``{epoch, state_dict[, optimizer]}``, written by ``torch.save`` to a
temporary file that is then renamed over the target. ``pretrained``
restores the weights only (the epoch resets); ``resume`` also restores the
optimizer state and the epoch (train.py:137-140). A missing file is a
warning. Loading tolerates partial checkpoints: a shape-mismatched entry is
skipped with a warning and a missing one keeps its fresh value
(utils/helper.py:103-117). A bare state dict (a ``.pth`` of weights) loads
as the weights of an epoch-0 checkpoint.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import torch

log = logging.getLogger(__name__)


def save_checkpoint(path, model: torch.nn.Module, epoch: int,
                    optimizer: Optional[torch.optim.Optimizer] = None
                    ) -> None:
    data = {"epoch": int(epoch), "state_dict": model.state_dict()}
    if optimizer is not None:
        data["optimizer"] = optimizer.state_dict()
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(data, tmp)
    tmp.replace(path)


def load_checkpoint(path, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    resume: bool = False) -> int:
    """Restore a checkpoint into ``model`` (and, when resuming, into
    ``optimizer``). Returns the checkpoint's epoch when ``resume``, else 0;
    0 for a missing file too."""
    path = Path(path)
    if not path.exists():
        log.warning("Model path %s does not exist!", path)
        return 0

    data = torch.load(path, map_location="cpu", weights_only=True)
    state = data.get("state_dict", data)
    epoch = int(data.get("epoch", 0)) if resume else 0

    own = model.state_dict()
    loadable = {}
    for key, value in own.items():
        if key not in state:
            log.warning("no parameter %s available", key)
        elif tuple(state[key].shape) != tuple(value.shape):
            log.warning("skip parameter %s because of shape mismatch", key)
        else:
            loadable[key] = state[key]
    model.load_state_dict(loadable, strict=False)

    if resume and optimizer is not None and "optimizer" in data:
        try:
            optimizer.load_state_dict(data["optimizer"])
            log.info("restore optimizer state at epoch %d", epoch)
        except (ValueError, KeyError) as exc:  # structure drift
            log.warning("could not restore optimizer state: %s", exc)

    log.info("restored weights from %s", path)
    return epoch
