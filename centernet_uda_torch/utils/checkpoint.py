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

``load_backbone_pretrained`` is the backend's own ``pretrained`` param
(``centernet_uda_tpu/utils/torch_import.py:load_backbone_pretrained``):
ImageNet trunk weights in the trunk's bare naming (torchvision's ResNet and
MobileNetV2, the DLA zoo's, EfficientNet-PyTorch's) load into the trunk
(``base.*``), and every other parameter keeps its fresh value. A path is
used as given; ``True`` searches the torch hub cache and raises
``FileNotFoundError`` when nothing is there (nothing is downloaded).
"""

from __future__ import annotations

import glob
import logging
import os
from pathlib import Path
from typing import Callable, Dict, Optional

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


def _resnet_trunk_key(key: str) -> Optional[str]:
    """torchvision's ``conv1``/``bn1``/``layer{i}.*`` -> the reference's
    ``base.0``/``base.1``/``base.{i + 3}.*`` (``fc.*`` is not the trunk)."""
    head, _, rest = key.partition(".")
    if head in ("conv1", "bn1"):
        return f"base.{0 if head == 'conv1' else 1}.{rest}"
    if head.startswith("layer"):
        return f"base.{int(head[len('layer'):]) + 3}.{rest}"
    return None


# trunk-file key -> the port's (the reference's) key, per backend family
_TRUNK_KEYS: Dict[str, Callable[[str], Optional[str]]] = {
    "resnet": _resnet_trunk_key,
    "dla": lambda k: f"base.{k}",
    "mobilenetv2": lambda k: ("base." + k[len("features."):]
                              if k.startswith("features.") else None),
    "efficientnet": lambda k: f"base.{k}",
}

# torch hub cache file prefixes per backend name, for ``pretrained: true``
_HUB_FILE_PREFIXES = {
    "resnet18": ("resnet18-",), "resnet34": ("resnet34-",),
    "resnet50": ("resnet50-",), "resnet101": ("resnet101-",),
    "resnet152": ("resnet152-",), "dla34": ("dla34-",),
    "mobilenetv2": ("mobilenet_v2-",),
}


def resolve_pretrained_path(backend_name: str, pretrained) -> str:
    """The weight file of a backend's ``pretrained`` param: a path as
    given (it must exist), or for ``True`` the first match in the torch hub
    cache (``$TORCH_HOME/hub/checkpoints``, ``$TORCH_HOME/checkpoints``)."""
    if isinstance(pretrained, (str, bytes, os.PathLike)):
        path = os.path.expanduser(os.fsdecode(pretrained))
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"backend pretrained weights not found: {path}")
        return path
    prefixes = _HUB_FILE_PREFIXES.get(
        backend_name, (backend_name + "-",)
        if backend_name.startswith("efficientnet") else ())
    torch_home = os.environ.get(
        "TORCH_HOME", os.path.join(os.path.expanduser("~"), ".cache", "torch"))
    searched = []
    for cache_dir in (os.path.join(torch_home, "hub", "checkpoints"),
                      os.path.join(torch_home, "checkpoints")):
        for prefix in prefixes:
            pattern = os.path.join(cache_dir, prefix + "*.pth")
            searched.append(pattern)
            hits = sorted(glob.glob(pattern))
            if hits:
                return hits[0]
    raise FileNotFoundError(
        f"pretrained=True for backend '{backend_name}' but no cached weights "
        f"found (searched {searched}); nothing is downloaded: put the "
        "checkpoint in the torch hub cache or set "
        "model.backend.params.pretrained to its path")


def load_backbone_pretrained(module: torch.nn.Module, family: str,
                             backend_name: str, pretrained) -> None:
    """Load trunk weights into ``module.base`` (no-op for a falsy
    ``pretrained``); missing and shape-mismatched entries keep their fresh
    values with a warning, as the JAX package's importer does."""
    if not pretrained:
        return
    path = resolve_pretrained_path(backend_name, pretrained)
    log.info("loading backbone pretrained weights for %s from %s",
             backend_name, path)
    data = torch.load(path, map_location="cpu", weights_only=True)
    data = data.get("state_dict", data)
    key_of = _TRUNK_KEYS[family]
    state = {}
    for key, value in data.items():
        if key.startswith("module") and not key.startswith("module_list"):
            key = key[7:]
        own = key_of(key)
        if own is not None:
            state[own] = value
    loadable = {}
    for key, value in module.state_dict().items():
        if not key.startswith("base.") or key.endswith("num_batches_tracked"):
            continue
        if key not in state:
            log.warning("no parameter %s available in the trunk weights",
                        key)
        elif tuple(state[key].shape) != tuple(value.shape):
            log.warning("skip parameter %s because of shape mismatch", key)
        else:
            loadable[key] = state[key]
    module.load_state_dict(loadable, strict=False)
    log.info("%s trunk import: %d entries restored", backend_name,
             len(loadable))
