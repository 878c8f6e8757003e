"""CenterNet MobileNetV2 backend with the optional DCNv2 neck (NCHW).

Counterpart of ``centernet_uda_tpu/models/mobilenetv2.py`` (the reference's
``backends/mobilenetv2.py``): torchvision's MobileNetV2 feature extractor
(alpha 1.0; inverted residual bottlenecks, ReLU6, the 1280-channel 1x1 head
conv), a 3-stage neck of [DCN(256) + BN + ReLU] (with ``use_dcn``) then a
4x4 stride-2 transposed conv + BN + ReLU, optional skips from feature
layers 13 (96 channels, /16) into stage 0 and 6 (32 channels, /8) into
stage 1, each a 1x1 conv added to the raw transposed-conv output before its
BatchNorm, and the heads (head_conv 64, no heatmap bias).

Module names reproduce the reference state dict, the names the JAX
package's importer maps (``centernet_uda_tpu/utils/torch_import.py``):
``base.0.0.weight`` (stem), ``base.{1..17}.conv...`` (torchvision's
InvertedResidual layout), ``base.18.0.weight`` (head conv),
``deconv_layers.{6s+k}`` with DCN (``3s+k`` without), ``skip_0`` and
``skip_3``, ``hm.0.weight``.

The transposed conv is ``ConvTranspose2d(256, 256, 4, stride=2, padding=1,
bias=False)``: flax's ``ConvTranspose(4, 2, "SAME")`` pads the dilated input
by 2 on each side, as this does, with the kernel the other way round
spatially; the weight bridge flips it (``utils/weights.py``).

Parameters are initialised as flax initialises the JAX model (convs and
transposed convs lecun-normal over their fan-in, DCN weights uniform
+-1/sqrt(9 Cin), offset convs, biases and BN shifts zero, BN scales one),
drawn on the CPU from a seeded generator and then moved to ``device``.
``dtype`` is the compute dtype of every layer; the heads come out float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn

from centernet_uda_torch import resolve_device
from centernet_uda_torch.models.common import (
    Backend,
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    apply_heads,
    freeze_trunk,
    head,
    lecun_normal_,
    make_heads_dict,
    reset_head,
)
from centernet_uda_torch.ops.dcn import DCN
from centernet_uda_torch.utils.checkpoint import load_backbone_pretrained

# torchvision mobilenet_v2 inverted-residual config: (expand, channels,
# repeats, stride)
INVERTED_RESIDUAL_CFG = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
# neck stage -> feature layer whose output it adds (stage 0: layer 13, 96
# channels at /16; stage 1: layer 6, 32 channels at /8)
SKIP_MAPPING = {0: 13, 1: 6}
FEATURE_CHANNELS = {6: 32, 13: 96}
NECK_CHANNELS = 256
HEAD_CONV = 64


class ReLU6(nn.Module):
    """min(max(x, 0), 6), as the JAX package writes it: at x = 0 or 6
    exactly the gradient is halved (a tie of max / min), where
    ``torch.clamp`` passes it whole and ``nn.ReLU6`` not at all. Exact
    zeros are common (a BN of zeros at init gives its bias, 0)."""

    def forward(self, x):
        return torch.minimum(torch.maximum(x, x.new_zeros(())),
                             x.new_full((), 6.0))


def _conv_bn_relu6(cin: int, cout: int, kernel: int, stride: int = 1,
                   groups: int = 1, dtype=torch.float32) -> nn.Sequential:
    return nn.Sequential(
        Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups,
               bias=False, dtype=dtype),
        BatchNorm2d(cout, dtype), ReLU6())


class InvertedResidual(nn.Module):
    """torchvision's block: [1x1 expand + BN + ReLU6] (expand != 1), 3x3
    depthwise + BN + ReLU6, 1x1 linear project + BN, and the residual
    where the stride is 1 and the width unchanged."""

    def __init__(self, cin: int, cout: int, stride: int, expand: int,
                 dtype=torch.float32):
        super().__init__()
        hidden = cin * expand
        self.use_res = stride == 1 and cin == cout
        layers: List[nn.Module] = []
        if expand != 1:
            layers.append(_conv_bn_relu6(cin, hidden, 1, dtype=dtype))
        layers += [
            _conv_bn_relu6(hidden, hidden, 3, stride, groups=hidden,
                           dtype=dtype),
            Conv2d(hidden, cout, 1, bias=False, dtype=dtype),
            BatchNorm2d(cout, dtype)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.use_res else y


def mobilenetv2_features(dtype=torch.float32) -> nn.Sequential:
    """``mobilenet_v2().features``: the stem (index 0), 17 inverted
    residual blocks (1-17) and the 1280-channel head conv (18)."""
    layers: List[nn.Module] = [_conv_bn_relu6(3, 32, 3, 2, dtype=dtype)]
    cin = 32
    for expand, c, n, s in INVERTED_RESIDUAL_CFG:
        for i in range(n):
            layers.append(InvertedResidual(cin, c, s if i == 0 else 1,
                                           expand, dtype))
            cin = c
    layers.append(_conv_bn_relu6(cin, 1280, 1, dtype=dtype))
    return nn.Sequential(*layers)


class CenterMobileNetV2(nn.Module):
    def __init__(self, heads: Dict[str, int], use_dcn: bool = False,
                 use_skip: bool = False, dcn_impl: str = "auto",
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32):
        super().__init__()
        self.heads = dict(heads)
        self.use_dcn, self.use_skip = use_dcn, use_skip
        self.base = mobilenetv2_features(dtype)
        layers: List[nn.Module] = []
        cin = 1280
        for _ in range(3):
            if use_dcn:
                layers += [DCN(cin, NECK_CHANNELS, impl=dcn_impl,
                               dtype=dtype),
                           BatchNorm2d(NECK_CHANNELS, dtype),
                           nn.ReLU(inplace=True)]
                cin = NECK_CHANNELS
            layers += [ConvTranspose2d(cin, NECK_CHANNELS, 4, stride=2,
                                       padding=1, bias=False, dtype=dtype),
                       BatchNorm2d(NECK_CHANNELS, dtype),
                       nn.ReLU(inplace=True)]
            cin = NECK_CHANNELS
        self.deconv_layers = nn.Sequential(*layers)
        if use_skip:
            for stage, layer in SKIP_MAPPING.items():
                self.add_module(f"skip_{3 * stage}", Conv2d(
                    FEATURE_CHANNELS[layer], NECK_CHANNELS, 1, bias=True,
                    dtype=dtype))
        for name in sorted(self.heads):
            self.add_module(name, head(NECK_CHANNELS, HEAD_CONV,
                                       self.heads[name], dtype=dtype))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """flax's initialisation of the JAX model, drawn from
        ``generator`` in module order."""
        skip = {id(m.conv_offset_mask) for m in self.modules()
                if isinstance(m, DCN)}
        skip |= {id(m) for h in self.heads for m in getattr(self, h)}
        for mod in self.modules():
            if isinstance(mod, DCN):
                mod.reset_parameters(generator)
            elif isinstance(mod, BatchNorm2d):
                mod.reset_parameters()
            elif isinstance(mod, nn.ConvTranspose2d):
                # flax's fan-in of a (4, 4, in, out) kernel: 16 * in
                lecun_normal_(mod.weight, generator,
                              fan_in=mod.weight[:, 0].numel())
            elif isinstance(mod, nn.Conv2d) and id(mod) not in skip:
                lecun_normal_(mod.weight, generator)
                if mod.bias is not None:
                    nn.init.zeros_(mod.bias)
        for name in sorted(self.heads):
            reset_head(getattr(self, name), 0.0, generator)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = {}
        for i, layer in enumerate(self.base):
            x = layer(x)
            if i in FEATURE_CHANNELS:
                feats[i] = x
        per_stage = 6 if self.use_dcn else 3
        for stage in range(3):
            mods = list(self.deconv_layers[per_stage * stage:
                                           per_stage * (stage + 1)])
            if self.use_dcn:
                dcn, bn, relu = mods[:3]
                x = relu(bn(dcn(x)))
            deconv, bn, relu = mods[-3:]
            x = deconv(x)
            if self.use_skip and stage in SKIP_MAPPING:
                skip = getattr(self, f"skip_{3 * stage}")
                x = skip(feats[SKIP_MAPPING[stage]]) + x
            x = relu(bn(x))
        return apply_heads(self, self.heads, x)


def build(num_classes: int, num_keypoints: int = 0, pretrained=None,
          freeze_base: bool = False, use_dcn: bool = False,
          use_skip: bool = False, rotated_boxes: bool = False,
          dcn_impl: str = "auto", seed: int = 0, device="cuda",
          dtype=torch.float32) -> Backend:
    """Factory matching the reference signature (backends/mobilenetv2.py:
    169-186). Parameters are drawn on the CPU from ``torch.Generator().
    manual_seed(seed)`` and the module is then moved to ``device``;
    ``pretrained`` (a path, or ``True`` for the torch hub cache) loads
    torchvision's trunk weights; ``freeze_base`` leaves the trunk out of
    the optimizer."""
    device = resolve_device(device)
    heads = make_heads_dict(num_classes, num_keypoints, rotated_boxes)
    module = CenterMobileNetV2(
        heads, use_dcn=use_dcn, use_skip=use_skip, dcn_impl=dcn_impl,
        generator=torch.Generator().manual_seed(seed), dtype=dtype)
    load_backbone_pretrained(module, "mobilenetv2", "mobilenetv2", pretrained)
    if freeze_base:
        freeze_trunk(module)
    return Backend(module=module.to(device), down_ratio=4,
                   rotated_boxes=rotated_boxes, num_classes=num_classes,
                   num_keypoints=num_keypoints, heads=heads,
                   name="mobilenetv2")
