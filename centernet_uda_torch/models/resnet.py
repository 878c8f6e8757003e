"""CenterNet ResNet backend (ResNet-18/34/50/101/152), NCHW.

Counterpart of ``centernet_uda_tpu/models/resnet.py`` (the reference's
``backends/resnet.py``): a torchvision ResNet-v1 trunk without its avgpool
and fc, a 3-stage deconv neck to stride 4 (4x4 stride-2 transposed convs to
256 channels, BatchNorm, ReLU) and the heads (head_conv 64, no heatmap
bias).

Padding follows the JAX package, not torchvision. The 7x7 stem and the max
pool pad (3, 3) and (1, 1), as both do; but the stride-2 3x3 convs
(BasicBlock ``conv1``, Bottleneck ``conv2``) pad ``"SAME"``, computed from
each input's size (``SameConv2d``): (0, 1) on an even map, (1, 1) on an odd
one, where torchvision pads (1, 1) always. The other 3x3 convs are
stride 1, where ``"SAME"`` is (1, 1).

Module names reproduce the reference state dict: the trunk is
``base = Sequential(conv1, bn1, relu, maxpool, layer1..layer4)``
(``base.0.weight``, ``base.4.0.conv1.weight``,
``base.5.0.downsample.0.weight``, ...), the neck ``deconv_layers.{3s}`` /
``{3s + 1}``, the heads ``hm.0.weight`` ... Parameters are initialised as
flax initialises the JAX model, drawn on the CPU from a seeded generator
and then moved to ``device``; ``dtype`` is the compute dtype of every
layer, and the heads come out float32.
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
    SameConv2d,
    add_heads,
    apply_heads,
    deconv_neck,
    freeze_trunk,
    init_like_flax,
    make_heads_dict,
)
from centernet_uda_torch.utils.checkpoint import load_backbone_pretrained

# num_layers -> (block, stage sizes, trunk output channels)
RESNET_CONFIGS = {
    18: ("basic", (2, 2, 2, 2), 512),
    34: ("basic", (3, 4, 6, 3), 512),
    50: ("bottleneck", (3, 4, 6, 3), 2048),
    101: ("bottleneck", (3, 4, 23, 3), 2048),
    152: ("bottleneck", (3, 8, 36, 3), 2048),
}
HEAD_CONV = 64


def _conv3x3(cin: int, cout: int, stride: int, dtype) -> nn.Module:
    if stride == 1:
        return Conv2d(cin, cout, 3, padding=1, bias=False, dtype=dtype)
    return SameConv2d(cin, cout, 3, stride=stride, bias=False, dtype=dtype)


def _downsample(cin: int, cout: int, stride: int, dtype
                ) -> Optional[nn.Sequential]:
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(Conv2d(cin, cout, 1, stride=stride, bias=False,
                                dtype=dtype), BatchNorm2d(cout, dtype))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = _conv3x3(cin, planes, stride, dtype)
        self.bn1 = BatchNorm2d(planes, dtype)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = _conv3x3(planes, planes, 1, dtype)
        self.bn2 = BatchNorm2d(planes, dtype)
        self.downsample = _downsample(cin, planes, stride, dtype)

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(planes, dtype)
        self.conv2 = _conv3x3(planes, planes, stride, dtype)
        self.bn2 = BatchNorm2d(planes, dtype)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm2d(planes * 4, dtype)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = _downsample(cin, planes * 4, stride, dtype)

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


def resnet_trunk(num_layers: int, dtype=torch.float32) -> nn.Sequential:
    """``Sequential(conv1, bn1, relu, maxpool, layer1..layer4)``, the
    children of torchvision's ResNet without avgpool and fc."""
    kind, stages, _ = RESNET_CONFIGS[num_layers]
    block = BasicBlock if kind == "basic" else Bottleneck
    layers: List[nn.Module] = [
        Conv2d(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype),
        BatchNorm2d(64, dtype), nn.ReLU(inplace=True),
        nn.MaxPool2d(3, stride=2, padding=1)]
    cin, planes = 64, 64
    for stage, num_blocks in enumerate(stages):
        blocks = []
        for i in range(num_blocks):
            stride = 2 if stage > 0 and i == 0 else 1
            blocks.append(block(cin, planes, stride, dtype))
            cin = planes * block.expansion
        layers.append(nn.Sequential(*blocks))
        planes *= 2
    return nn.Sequential(*layers)


class CenterResNet(nn.Module):
    def __init__(self, num_layers: int, heads: Dict[str, int],
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32):
        super().__init__()
        self.heads = dict(heads)
        self.base = resnet_trunk(num_layers, dtype)
        self.deconv_layers = deconv_neck(RESNET_CONFIGS[num_layers][2],
                                         dtype=dtype)
        add_heads(self, self.heads, 256, HEAD_CONV, dtype)
        init_like_flax(self, self.heads, generator)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return apply_heads(self, self.heads,
                           self.deconv_layers(self.base(x)))


def build(num_layers: int, num_classes: int, num_keypoints: int = 0,
          pretrained=None, freeze_base: bool = False,
          rotated_boxes: bool = False, dcn_impl: str = "auto",
          seed: int = 0, device="cuda", dtype=torch.float32) -> Backend:
    """Factory matching the reference signature (backends/resnet.py:
    103-120). Parameters are drawn on the CPU from ``torch.Generator().
    manual_seed(seed)``; ``pretrained`` (a path, or ``True`` for the torch
    hub cache) loads torchvision trunk weights; ``freeze_base`` leaves the
    trunk out of the optimizer. ``dcn_impl`` is unused (no DCN)."""
    if num_layers not in RESNET_CONFIGS:
        raise ValueError(f"unsupported resnet{num_layers}")
    device = resolve_device(device)
    heads = make_heads_dict(num_classes, num_keypoints, rotated_boxes)
    module = CenterResNet(num_layers, heads,
                          generator=torch.Generator().manual_seed(seed),
                          dtype=dtype)
    name = f"resnet{num_layers}"
    load_backbone_pretrained(module, "resnet", name, pretrained)
    if freeze_base:
        freeze_trunk(module)
    return Backend(module=module.to(device), down_ratio=4,
                   rotated_boxes=rotated_boxes, num_classes=num_classes,
                   num_keypoints=num_keypoints, heads=heads, name=name)
