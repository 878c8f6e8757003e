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
as the weights of an epoch-0 checkpoint. A leading ``module.`` (the
reference's DataParallel prefix) is stripped from every key, as the JAX
package's importer strips it.

A checkpoint of the JAX package (``centernet_uda_tpu/utils/checkpoint.py``:
a pickle of numpy trees, ``{epoch, params, batch_stats[, disc_params,
opt_state, disc_opt_state]}``, told from a torch file by its content: not
a zip, and not led by torch's legacy magic number) loads too:
``read_checkpoint`` reads it with an unpickler that builds numpy
arrays and builtin containers and turns every other class (optax's states)
into an inert ``Stub``, so nothing imports JAX and no pickled code runs;
``params``/``batch_stats`` become the backend's state dict through
``utils/weights.py:state_dict_from_jax`` (by the backend's name) and
``disc_params`` the discriminator's. Its weights load and its epoch comes
along under ``resume``; its optimizer state is not read (the optimizer
starts fresh, with a log line), as the JAX package's own ``.pth`` route
does.

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
import pickle
import zipfile
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from centernet_uda_torch.utils.weights import (disc_state_dict_from_jax,
                                               state_dict_from_jax)

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


class Stub:
    """What the JAX-checkpoint reader makes of an object whose class it
    does not admit (an optax state): its arguments and state, kept as
    data."""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls)

    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs

    def __setstate__(self, state):
        self.state = state


# the globals a pickle of numpy trees needs, across numpy 1 and 2
_ADMITTED = {
    ("numpy", "dtype"), ("numpy", "ndarray"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
    ("_codecs", "encode"), ("collections", "OrderedDict"),
} | {("builtins", name) for name in (
    "dict", "list", "tuple", "set", "frozenset", "int", "float", "complex",
    "bool", "str", "bytes", "bytearray")}


class _NumpyTreeUnpickler(pickle.Unpickler):
    """Builds numpy arrays and builtin containers; every other class
    becomes a ``Stub`` subclass of the same name."""

    def find_class(self, module, name):
        if (module, name) in _ADMITTED:
            return super().find_class(module, name)
        return type(name, (Stub,), {"__module__": f"stub:{module}"})


def _read_jax_checkpoint(path) -> Optional[Dict]:
    """The JAX package's checkpoint dict, or None for a file that
    ``torch.load`` reads: a ``torch.save`` zip, or torch's legacy format
    (before torch 1.6, or ``_use_new_zipfile_serialization=False``), whose
    first pickle is torch's magic number."""
    if zipfile.is_zipfile(path):
        return None
    with open(path, "rb") as f:
        data = _NumpyTreeUnpickler(f).load()
    if (isinstance(data, int)
            and data == torch.serialization.MAGIC_NUMBER):
        return None
    if not isinstance(data, dict) or "params" not in data:
        raise ValueError(f"{path} is neither a torch checkpoint nor a JAX "
                         "checkpoint ({epoch, params, batch_stats, ...})")
    return data


def is_jax_checkpoint(path) -> bool:
    """True for an existing file that the JAX package wrote."""
    path = Path(path)
    return path.is_file() and _read_jax_checkpoint(path) is not None


def _strip_module_prefix(state: Dict) -> Dict:
    return {(key[len("module."):] if key.startswith("module.") else key):
            value for key, value in state.items()}


def read_checkpoint(path, backend_name: str = "") -> Dict:
    """A checkpoint as ``{"epoch", "state_dict"[, "optimizer"]}``, with
    ``"disc_state_dict"`` for a JAX checkpoint that holds a discriminator
    and ``"jax"`` saying which package wrote it. A JAX checkpoint needs
    ``backend_name`` (``Backend.name``) to map its weights."""
    path = Path(path)
    data = _read_jax_checkpoint(path)
    if data is None:
        data = torch.load(path, map_location="cpu", weights_only=True)
        if "state_dict" not in data:
            data = {"state_dict": data}
        return {**data, "jax": False}
    if not backend_name:
        raise ValueError(f"{path} is a JAX checkpoint: its weights map by "
                         "the backend's name, and none was given")
    out = {"epoch": int(data.get("epoch", 0)), "jax": True,
           "state_dict": state_dict_from_jax(
               {"params": data["params"],
                "batch_stats": data.get("batch_stats") or {}},
               backend_name)}
    if data.get("disc_params"):
        out["disc_state_dict"] = disc_state_dict_from_jax(data["disc_params"])
    return out


def load_checkpoint(path, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    resume: bool = False, backend_name: str = "",
                    part: str = "state_dict") -> int:
    """Restore a checkpoint's ``part`` (``state_dict``, or a JAX
    checkpoint's ``disc_state_dict``) into ``model`` and, when resuming, its
    optimizer state into ``optimizer``. Returns the checkpoint's epoch when
    ``resume``, else 0; 0 for a missing file too."""
    path = Path(path)
    if not path.exists():
        log.warning("Model path %s does not exist!", path)
        return 0

    data = read_checkpoint(path, backend_name)
    epoch = int(data.get("epoch", 0)) if resume else 0
    if part not in data:
        log.warning("%s holds no %s", path, part)
        return epoch
    state = _strip_module_prefix(data[part])

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

    if resume and optimizer is not None:
        if data["jax"]:
            log.info("the JAX checkpoint's optimizer state is not read: "
                     "the optimizer starts fresh at epoch %d", epoch)
        elif "optimizer" in data:
            try:
                optimizer.load_state_dict(data["optimizer"])
                log.info("restore optimizer state at epoch %d", epoch)
            except (ValueError, KeyError) as exc:  # structure drift
                log.warning("could not restore optimizer state: %s", exc)

    log.info("restored %d of %d weights from %s", len(loadable), len(own),
             path)
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
    for key, value in _strip_module_prefix(data).items():
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
