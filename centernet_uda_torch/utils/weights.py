"""Weight bridge from the JAX package's variables to the port.

``state_dict_from_jax(variables, backend)`` turns the ``{"params",
"batch_stats"}`` trees of a ``centernet_uda_tpu`` backend (nested dicts of
arrays) into the port's state dict of the same backend, with the key maps
of ``centernet_uda_tpu/utils/torch_import.py`` run backwards: ``dla``
(``_dla_path_to_torch``), ``mobilenetv2`` (``_mobilenetv2_path_to_torch``),
``resnet`` (``_resnet_path_to_torch``) and ``efficientnet``
(``_efficientnet_path_to_torch``), selected by backend name as the JAX
package's ``import_state_dict`` selects its shims (digits ignored, so
``dla34`` is ``dla`` and ``efficientnet-b0`` is ``efficientnet``):

- conv kernels HWIO -> OIHW (a depthwise (k, k, 1, c) kernel -> (c, 1, k,
  k));
- transposed-conv kernels (k, k, in, out) -> (in, out, k, k), spatially
  flipped (flax's ``ConvTranspose`` does not flip, torch's does);
- BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
  running_var (``num_batches_tracked`` starts at 0).

The result loads with ``module.load_state_dict(sd)`` and, saved with
``torch.save``, imports back into the JAX package through its own
``import_state_dict``. ``disc_state_dict_from_jax(params)`` does the same
for the ADVENT discriminator's ``conv0..conv4``.
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


def _conv_transpose(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))[..., ::-1,
                                                               ::-1])


# torchvision's InvertedResidual: JAX (conv|bn)<i> -> key inside .conv, for
# layer 1 (no expand conv) and the others
_MNV2_CONV = {True: {0: "0.0", 1: "1"}, False: {0: "0.0", 1: "1.0", 2: "2"}}
_MNV2_BN = {True: {0: "0.1", 1: "2"}, False: {0: "0.1", 1: "1.1", 2: "3"}}


def _mobilenetv2_key(path: Tuple[str, ...], use_dcn: bool
                     ) -> Optional[Tuple[str, object]]:
    """(torch key, transform) of one JAX MobileNetV2 leaf, or None."""
    parts = list(path)
    leaf, top = parts[-1], parts[0]
    if top == "base":
        sub = parts[1]
        fixed = {"stem_conv": "base.0.0", "stem_bn": "base.0.1",
                 "head_conv": "base.18.0", "head_bn": "base.18.1"}
        if sub in fixed:
            if sub.endswith("conv"):
                return f"{fixed[sub]}.weight", _conv
            return _bn(fixed[sub], leaf)
        if sub.startswith("layer"):
            lid = int(sub[len("layer"):])
            mod = parts[2]
            idx = int(mod[-1])
            if mod.startswith("conv"):
                return f"base.{lid}.conv.{_MNV2_CONV[lid == 1][idx]}.weight", \
                    _conv
            return _bn(f"base.{lid}.conv.{_MNV2_BN[lid == 1][idx]}", leaf)
        return None
    per_stage = 6 if use_dcn else 3
    for name, offset in (("neck_dcn_bn", 1), ("neck_bn", 4 if use_dcn else 1)):
        if top.startswith(name) and top[len(name):].isdigit():
            stage = int(top[len(name):])
            return _bn(f"deconv_layers.{per_stage * stage + offset}", leaf)
    if top.startswith("neck_dcn"):
        key = f"deconv_layers.{per_stage * int(top[len('neck_dcn'):])}"
        if parts[-2] == "conv_offset_mask":
            return ((f"{key}.conv_offset_mask.weight", _conv)
                    if leaf == "kernel"
                    else (f"{key}.conv_offset_mask.bias", _same))
        return f"{key}.{leaf}", _conv if leaf == "weight" else _same
    if top.startswith("neck_deconv"):
        stage = int(top[len("neck_deconv"):])
        offset = 3 if use_dcn else 0
        return (f"deconv_layers.{per_stage * stage + offset}.weight",
                _conv_transpose)
    if top.startswith("skip_"):
        key = f"skip_{3 * int(top[len('skip_'):])}"
        return ((f"{key}.weight", _conv) if leaf == "kernel"
                else (f"{key}.bias", _same))
    if top == "heads":
        return _heads_key(parts, leaf)
    return None


def _heads_key(parts, leaf):
    name, kind = parts[1].rsplit("_", 1)
    idx = 0 if kind == "conv" else 2
    if leaf == "kernel":
        return f"{name}.{idx}.weight", _conv
    return f"{name}.{idx}.bias", _same


def _resnet_key(path: Tuple[str, ...]) -> Optional[Tuple[str, object]]:
    """(torch key, transform) of one JAX ResNet leaf, or None."""
    parts = list(path)
    leaf, top = parts[-1], parts[0]
    if top == "base":
        sub = parts[1]
        if sub == "conv1":
            return "base.0.weight", _conv
        if sub == "bn1":
            return _bn("base.1", leaf)
        stage, blk = sub.split("_")  # layer<i>, <block>
        prefix = f"base.{int(stage[len('layer'):]) + 3}.{blk}"
        mod = parts[2]
        if mod == "downsample_conv":
            return f"{prefix}.downsample.0.weight", _conv
        if mod == "downsample_bn":
            return _bn(f"{prefix}.downsample.1", leaf)
        if mod.startswith("conv"):
            return f"{prefix}.{mod}.weight", _conv
        return _bn(f"{prefix}.{mod}", leaf)
    if top == "neck":
        idx = int(parts[1][-1])
        if parts[1].startswith("deconv"):
            return f"deconv_layers.{3 * idx}.weight", _conv_transpose
        return _bn(f"deconv_layers.{3 * idx + 1}", leaf)
    if top == "heads":
        return _heads_key(parts, leaf)
    return None


# MBConv leaves: JAX module -> EfficientNet-PyTorch module
_EFFNET_BLOCK = {"expand_conv": "_expand_conv",
                 "depthwise_conv": "_depthwise_conv",
                 "project_conv": "_project_conv", "se_reduce": "_se_reduce",
                 "se_expand": "_se_expand", "bn0": "_bn0", "bn1": "_bn1",
                 "bn2": "_bn2"}
_EFFNET_SKIP = {"0": "skip_2", "1": "skip_5"}


def _efficientnet_key(path: Tuple[str, ...], use_upsample: bool
                      ) -> Optional[Tuple[str, object]]:
    """(torch key, transform) of one JAX EfficientNet leaf, or None."""
    parts = list(path)
    leaf, top = parts[-1], parts[0]

    def conv_or_bias(key):
        return (f"{key}.weight", _conv) if leaf == "kernel" else \
            (f"{key}.bias", _same)

    if top == "base":
        sub = parts[1]
        fixed = {"stem_conv": "base._conv_stem", "stem_bn": "base._bn0",
                 "head_conv": "base._conv_head", "head_bn": "base._bn1"}
        if sub in fixed:
            if sub.endswith("conv"):
                return f"{fixed[sub]}.weight", _conv
            return _bn(fixed[sub], leaf)
        mod = _EFFNET_BLOCK.get(parts[2])
        if mod is None:
            return None
        key = f"base._blocks.{int(sub[len('block'):])}.{mod}"
        if mod.startswith("_bn"):
            return _bn(key, leaf)
        return conv_or_bias(key)
    if top.startswith("neck_deconv"):
        return (f"deconv_layers.{3 * int(top[len('neck_deconv'):])}.weight",
                _conv_transpose)
    if top.startswith("neck_conv"):
        return (f"deconv_layers.{4 * int(top[len('neck_conv'):]) + 1}"
                ".weight", _conv)
    if top.startswith("neck_bn"):
        stage = int(top[len("neck_bn"):])
        idx = 4 * stage + 2 if use_upsample else 3 * stage + 1
        return _bn(f"deconv_layers.{idx}", leaf)
    if top.startswith("skip_"):
        stage, kind = top[len("skip_"):].split("_", 1)
        if kind == "conv":
            return conv_or_bias(f"{_EFFNET_SKIP[stage]}.0")
        return _bn(f"{_EFFNET_SKIP[stage]}.1", leaf)
    if top == "heads":
        return _heads_key(parts, leaf)
    return None


def state_dict_from_jax(variables, backend: str = "dla"
                        ) -> Dict[str, torch.Tensor]:
    """The port's state dict of ``backend`` ("dla", "dla34", "mobilenetv2",
    "resnet", "resnet18", "efficientnet", "efficientnet-b0", ...) from that
    JAX backend's ``variables``."""
    kind = "".join(c for c in backend if not c.isdigit())
    if kind == "dla":
        key_of = _dla_key
    elif kind == "resnet":
        key_of = _resnet_key
    elif kind in ("efficientnet", "efficientnet-b"):
        use_upsample = any(top.startswith("neck_conv")
                           for top in variables.get("params", {}))
        key_of = lambda path: _efficientnet_key(  # noqa: E731
            path, use_upsample)
    elif kind == "mobilenetv":
        # a DCN neck has neck_dcn* params and neck_dcn_bn* statistics
        use_dcn = any(top.startswith("neck_dcn")
                      for col in ("params", "batch_stats")
                      for top in variables.get(col, {}))
        key_of = lambda path: _mobilenetv2_key(path, use_dcn)  # noqa: E731
    else:
        raise KeyError(f"no weight bridge for backend {backend!r}")
    sd: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(dict(variables.get(collection, {}))
                                    ).items():
            spec = key_of(path)
            if spec is None:
                raise KeyError(f"no port key for {collection}/"
                               + "/".join(path))
            key, transform = spec
            sd[key] = torch.tensor(transform(np.asarray(value, np.float32)))
            if key.endswith(".running_mean"):
                sd[key[: -len("running_mean")] + "num_batches_tracked"] = (
                    torch.tensor(0, dtype=torch.long))
    return sd


def disc_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """The port's ``FCDiscriminator`` state dict from the JAX
    discriminator's ``params``: flax ``conv<i>`` (kernel (4, 4, Cin, Cout),
    bias) -> ``<2i>.weight`` (Cout, Cin, 4, 4) and ``<2i>.bias``."""
    sd: Dict[str, torch.Tensor] = {}
    for name, leaves in dict(params).items():
        idx = 2 * int(name[len("conv"):])
        sd[f"{idx}.weight"] = torch.tensor(
            _conv(np.asarray(leaves["kernel"], np.float32)))
        sd[f"{idx}.bias"] = torch.tensor(np.asarray(leaves["bias"],
                                                    np.float32))
    return sd
