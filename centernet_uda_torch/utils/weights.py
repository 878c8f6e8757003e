"""Weight bridge from the JAX package's DLA variables to the port.

``state_dict_from_jax(variables)`` turns the ``{"params", "batch_stats"}``
trees of ``centernet_uda_tpu``'s DLA (nested dicts of arrays) into the
port's ``DLASeg`` state dict, with the key map of
``centernet_uda_tpu/utils/torch_import.py`` (``_dla_path_to_torch``) run
backwards:

- conv kernels HWIO -> OIHW;
- the depthwise upsample kernel (k, k, 1, o) -> (o, 1, k, k);
- BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
  running_var (``num_batches_tracked`` starts at 0).

The result loads with ``module.load_state_dict(sd)`` and, saved with
``torch.save``, imports back into the JAX package through its own
``import_state_dict``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (3, 2, 0, 1))


def _same(w: np.ndarray) -> np.ndarray:
    return w


def _bn(prefix: str, leaf: str):
    return f"{prefix}.{_BN_LEAF[leaf]}", _same


def _dla_key(path: Tuple[str, ...]) -> Optional[Tuple[str, object]]:
    """(torch key, transform) of one JAX DLA leaf, or None if unmapped."""
    parts = list(path)
    leaf, mod, top = parts[-1], parts[-2], parts[0]
    if top == "base":
        sub = parts[1]
        if sub == "base_conv":
            return "base.base_layer.0.weight", _conv
        if sub == "base_bn":
            return _bn("base.base_layer.1", leaf)
        if sub.startswith(("level0_", "level1_")):
            level, kind = sub.split("_")
            idx = int(kind[-1])
            if kind.startswith("conv"):
                return f"base.{level}.{3 * idx}.weight", _conv
            return _bn(f"base.{level}.{3 * idx + 1}", leaf)
        trunk = "base." + ".".join(parts[1:-2])
        if mod == "project_conv":
            return f"{trunk}.project.0.weight", _conv
        if mod == "project_bn":
            return _bn(f"{trunk}.project.1", leaf)
        if mod.startswith("conv"):
            return f"{trunk}.{mod}.weight", _conv
        if mod.startswith("bn"):
            return _bn(f"{trunk}.{mod}", leaf)
        return None
    if top in ("dla_up", "ida_up"):
        if mod.startswith("up_") and leaf == "kernel":
            return ".".join(parts[:-1]) + ".weight", _conv
        if mod == "conv":  # the DCN's own weight and bias
            return (".".join(parts[:-1]) + f".{leaf}",
                    _conv if leaf == "weight" else _same)
        if mod == "conv_offset_mask":
            key = ".".join(parts[:-1])
            return ((key + ".weight", _conv) if leaf == "kernel"
                    else (key + ".bias", _same))
        if mod == "actf_bn":
            return _bn(".".join(parts[:-2]) + ".actf.0", leaf)
        return None
    if top.endswith(("_conv", "_out")):
        name, kind = top.rsplit("_", 1)
        idx = 0 if kind == "conv" else 2
        if leaf == "kernel":
            return f"{name}.{idx}.weight", _conv
        return f"{name}.{idx}.bias", _same
    return None


def state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The port's ``DLASeg`` state dict from JAX DLA ``variables``."""
    sd: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(dict(variables.get(collection, {}))
                                    ).items():
            spec = _dla_key(path)
            if spec is None:
                raise KeyError(f"no port key for {collection}/"
                               + "/".join(path))
            key, transform = spec
            sd[key] = torch.tensor(transform(np.asarray(value, np.float32)))
            if key.endswith(".running_mean"):
                sd[key[: -len("running_mean")] + "num_batches_tracked"] = (
                    torch.tensor(0, dtype=torch.long))
    return sd
