"""DLA-34 CenterNet backend with the DCNv2 upsampling neck (NCHW).

Counterpart of ``centernet_uda_tpu/models/dla.py`` (the reference's
``backends/dla.py``): the Deep Layer Aggregation trunk (``DLABasicBlock``,
``Root``, recursive ``Tree``; dla34 levels (1,1,1,2,2,1), channels
(16,32,64,128,256,512)), the deformable neck (``DeformConv`` = DCN + BN +
ReLU, ``IDAUp`` with bilinear-initialised depthwise transposed-conv
upsampling, ``DLAUp``) and ``DLASeg`` with the heads, the heatmap bias at
-2.19.

Module names reproduce the reference state dict (``base.base_layer.0.weight``,
``dla_up.ida_0.proj_1.conv.conv_offset_mask.weight``,
``dla_up.ida_0.proj_1.actf.0.running_var``, ``hm.2.bias``, ...). The trunk
runs the plain stem; the JAX package's space-to-depth stem is an exact TPU
rewrite of it. Parameters are initialised as flax initialises the JAX
model: convs lecun-normal, DCN weights uniform +-1/sqrt(9 Cin), offset
convs zero, BN scale 1 / bias 0.

``dtype`` (float32 or bfloat16, the config's ``precision``) is the compute
dtype of every layer, as the JAX package's ``dtype``: parameters stay
float32, activations, residual adds and ReLUs run in ``dtype``, and the
heads are cast to float32 at the end, so the loss, decode and the optimizer
stay float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from centernet_uda_torch import resolve_device
from centernet_uda_torch.models.common import (
    Backend,
    BatchNorm2d,
    Conv2d,
    apply_heads,
    freeze_trunk,
    head,
    lecun_normal_,
    make_heads_dict,
    reset_head,
)
from centernet_uda_torch.ops.dcn import DCN
from centernet_uda_torch.utils.checkpoint import load_backbone_pretrained

DLA34_LEVELS = (1, 1, 1, 2, 2, 1)
DLA34_CHANNELS = (16, 32, 64, 128, 256, 512)
HM_BIAS = -2.19


def _conv_bn_relu(cin: int, cout: int, kernel: int, stride: int = 1,
                  padding: int = 0, dtype=torch.float32) -> List[nn.Module]:
    return [Conv2d(cin, cout, kernel, stride, padding, bias=False,
                   dtype=dtype),
            BatchNorm2d(cout, dtype), nn.ReLU(inplace=True)]


class DLABasicBlock(nn.Module):
    """conv3x3-BN-ReLU-conv3x3-BN + residual."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, dilation,
                            dilation=dilation, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(planes, dtype)
        self.conv2 = Conv2d(planes, planes, 3, 1, dilation,
                            dilation=dilation, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(planes, dtype)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + residual)


class Root(nn.Module):
    """Conv over the concatenated children, BN, optional residual, ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, residual: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size, 1,
                           (kernel_size - 1) // 2, bias=False, dtype=dtype)
        self.bn = BatchNorm2d(out_channels, dtype)
        self.residual = residual

    def forward(self, *children):
        x = self.bn(self.conv(torch.cat(children, 1)))
        if self.residual:
            x = x + children[0]
        return F.relu(x)


class Tree(nn.Module):
    """Recursive aggregation tree."""

    def __init__(self, levels: int, in_channels: int, out_channels: int,
                 stride: int = 1, level_root: bool = False, root_dim: int = 0,
                 root_kernel_size: int = 1, dilation: int = 1,
                 root_residual: bool = False, dtype=torch.float32):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * out_channels
        if level_root:
            root_dim += in_channels
        if levels == 1:
            self.tree1 = DLABasicBlock(in_channels, out_channels, stride,
                                       dilation, dtype)
            self.tree2 = DLABasicBlock(out_channels, out_channels, 1,
                                       dilation, dtype)
            self.root = Root(root_dim, out_channels, root_kernel_size,
                             root_residual, dtype)
        else:
            self.tree1 = Tree(levels - 1, in_channels, out_channels, stride,
                              root_dim=0, root_kernel_size=root_kernel_size,
                              dilation=dilation, root_residual=root_residual,
                              dtype=dtype)
            self.tree2 = Tree(levels - 1, out_channels, out_channels,
                              root_dim=root_dim + out_channels,
                              root_kernel_size=root_kernel_size,
                              dilation=dilation, root_residual=root_residual,
                              dtype=dtype)
        self.levels = levels
        self.level_root = level_root
        self.stride = stride
        self.project = None
        if in_channels != out_channels:
            self.project = nn.Sequential(
                Conv2d(in_channels, out_channels, 1, bias=False, dtype=dtype),
                BatchNorm2d(out_channels, dtype))

    def forward(self, x, residual=None, children=None):
        children = [] if children is None else children
        bottom = F.max_pool2d(x, self.stride) if self.stride > 1 else x
        residual = self.project(bottom) if self.project is not None else bottom
        if self.level_root:
            children.append(bottom)
        x1 = self.tree1(x, residual)
        if self.levels == 1:
            x2 = self.tree2(x1)
            return self.root(x2, x1, *children)
        children.append(x1)
        return self.tree2(x1, children=children)


class DLATrunk(nn.Module):
    """DLA classifier trunk returning the 6 level outputs."""

    def __init__(self, levels: Sequence[int] = DLA34_LEVELS,
                 channels: Sequence[int] = DLA34_CHANNELS,
                 dtype=torch.float32):
        super().__init__()
        ch = list(channels)
        self.base_layer = nn.Sequential(*_conv_bn_relu(3, ch[0], 7, 1, 3,
                                                       dtype))
        self.level0 = self._conv_level(ch[0], ch[0], levels[0], 1, dtype)
        self.level1 = self._conv_level(ch[0], ch[1], levels[1], 2, dtype)
        self.level2 = Tree(levels[2], ch[1], ch[2], 2, level_root=False,
                           dtype=dtype)
        self.level3 = Tree(levels[3], ch[2], ch[3], 2, level_root=True,
                           dtype=dtype)
        self.level4 = Tree(levels[4], ch[3], ch[4], 2, level_root=True,
                           dtype=dtype)
        self.level5 = Tree(levels[5], ch[4], ch[5], 2, level_root=True,
                           dtype=dtype)

    @staticmethod
    def _conv_level(inplanes, planes, convs, stride, dtype):
        mods = []
        for i in range(convs):
            mods += _conv_bn_relu(inplanes, planes, 3, stride if i == 0 else 1,
                                  1, dtype)
            inplanes = planes
        return nn.Sequential(*mods)

    def forward(self, x) -> List[torch.Tensor]:
        x = self.base_layer(x)
        outputs = []
        for i in range(6):
            x = getattr(self, f"level{i}")(x)
            outputs.append(x)
        return outputs


def bilinear_up_weight(channels: int, factor: int) -> torch.Tensor:
    """The reference's ``fill_up_weights`` kernel, (channels, 1, k, k)."""
    k = 2 * factor
    f = math.ceil(k / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    w = torch.zeros(k, k)
    for i in range(k):
        for j in range(k):
            w[i, j] = (1 - abs(i / f - c)) * (1 - abs(j / f - c))
    return w.expand(channels, 1, k, k).clone()


class DepthwiseUp(nn.ConvTranspose2d):
    """Grouped (depthwise) transposed-conv 2x/4x upsample with the bilinear
    init (the reference's ``ConvTranspose2d(o, o, 2f, stride=f,
    padding=f // 2, groups=o)``), computing in ``dtype``."""

    def __init__(self, channels: int, factor: int, dtype=torch.float32):
        super().__init__(channels, channels, 2 * factor, stride=factor,
                         padding=factor // 2, output_padding=0,
                         groups=channels, bias=False)
        self.compute_dtype = dtype
        self.reset_bilinear()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), None,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)

    def reset_bilinear(self) -> None:
        with torch.no_grad():
            self.weight.copy_(bilinear_up_weight(self.out_channels,
                                                 self.stride[0]))


class DeformConv(nn.Module):
    """DCNv2 + BN + ReLU."""

    def __init__(self, cin: int, cout: int, dcn_impl: str = "auto",
                 dtype=torch.float32):
        super().__init__()
        self.actf = nn.Sequential(BatchNorm2d(cout, dtype),
                                  nn.ReLU(inplace=True))
        self.conv = DCN(cin, cout, 3, stride=1, padding=1, dilation=1,
                        impl=dcn_impl, dtype=dtype)

    def forward(self, x):
        return self.actf(self.conv(x))


class IDAUp(nn.Module):
    """Iterative deep aggregation upsampling; updates ``layers`` in place,
    as the reference does."""

    def __init__(self, o: int, channels: Sequence[int],
                 up_f: Sequence[int], dcn_impl: str = "auto",
                 dtype=torch.float32):
        super().__init__()
        for i in range(1, len(channels)):
            setattr(self, f"proj_{i}", DeformConv(channels[i], o, dcn_impl,
                                                  dtype))
            setattr(self, f"up_{i}", DepthwiseUp(o, int(up_f[i]), dtype))
            setattr(self, f"node_{i}", DeformConv(o, o, dcn_impl, dtype))

    def forward(self, layers: List[torch.Tensor], startp: int,
                endp: int) -> None:
        for i in range(startp + 1, endp):
            j = i - startp
            x = getattr(self, f"up_{j}")(getattr(self, f"proj_{j}")(layers[i]))
            layers[i] = getattr(self, f"node_{j}")(x + layers[i - 1])


class DLAUp(nn.Module):
    """Pyramid of IDAUp stages."""

    def __init__(self, startp: int, channels: Sequence[int],
                 scales: Sequence[int], dcn_impl: str = "auto",
                 dtype=torch.float32):
        super().__init__()
        self.startp = startp
        channels = list(channels)
        in_channels = list(channels)
        scales = list(scales)
        for i in range(len(channels) - 1):
            j = -i - 2
            setattr(self, f"ida_{i}", IDAUp(
                channels[j], in_channels[j:],
                [s // scales[j] for s in scales[j:]], dcn_impl, dtype))
            scales[j + 1:] = [scales[j]] * len(scales[j + 1:])
            in_channels[j + 1:] = [channels[j]] * len(in_channels[j + 1:])

    def forward(self, layers: List[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        out = [layers[-1]]
        for i in range(len(layers) - self.startp - 1):
            getattr(self, f"ida_{i}")(layers, len(layers) - i - 2, len(layers))
            out.insert(0, layers[-1])
        return out


class DLASeg(nn.Module):
    """DLA-34 CenterNet model: trunk -> DLAUp -> IDAUp -> heads."""

    def __init__(self, heads: Dict[str, int], down_ratio: int = 4,
                 final_kernel: int = 1, last_level: int = 5,
                 head_conv: int = 256, levels: Sequence[int] = DLA34_LEVELS,
                 channels: Sequence[int] = DLA34_CHANNELS,
                 dcn_impl: str = "auto",
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32):
        super().__init__()
        if down_ratio not in (2, 4, 8, 16):
            raise ValueError(f"down_ratio must be 2, 4, 8 or 16, got "
                             f"{down_ratio}")
        self.first_level = int(math.log2(down_ratio))
        self.last_level = last_level
        self.heads = dict(heads)
        channels = list(channels)
        fl = self.first_level
        self.base = DLATrunk(levels, channels, dtype)
        scales = [2 ** i for i in range(len(channels[fl:]))]
        self.dla_up = DLAUp(fl, channels[fl:], scales, dcn_impl, dtype)
        self.ida_up = IDAUp(channels[fl], channels[fl:last_level],
                            [2 ** i for i in range(last_level - fl)],
                            dcn_impl, dtype)
        for name in sorted(self.heads):
            self.add_module(name, head(channels[fl], head_conv,
                                       self.heads[name], final_kernel, dtype))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """flax's initialisation of the JAX model, drawn from
        ``generator`` in module order."""
        # offset convs are the DCN's and heads are reset_head's to set
        skip = {id(m.conv_offset_mask) for m in self.modules()
                if isinstance(m, DCN)}
        skip |= {id(m) for h in self.heads for m in getattr(self, h)}
        for mod in self.modules():
            if isinstance(mod, DCN):
                mod.reset_parameters(generator)
            elif isinstance(mod, DepthwiseUp):
                mod.reset_bilinear()
            elif isinstance(mod, BatchNorm2d):
                mod.reset_parameters()
            elif isinstance(mod, nn.Conv2d) and id(mod) not in skip:
                lecun_normal_(mod.weight, generator)
        for name in sorted(self.heads):
            reset_head(getattr(self, name),
                       HM_BIAS if "hm" in name else 0.0, generator)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.dla_up(self.base(x))
        y = list(feats[: self.last_level - self.first_level])
        self.ida_up(y, 0, len(y))
        return apply_heads(self, self.heads, y[-1])


def build(num_classes: int, num_keypoints: int = 0, head_conv: int = 256,
          down_ratio: int = 4, freeze_base: bool = False,
          rotated_boxes: bool = False, pretrained=None,
          dcn_impl: str = "auto", levels: Sequence[int] = DLA34_LEVELS,
          channels: Sequence[int] = DLA34_CHANNELS, seed: int = 0,
          device="cuda", dtype=torch.float32) -> Backend:
    """Factory matching the reference signature (backends/dla.py:513-531).

    Parameters are drawn on the CPU from ``torch.Generator().manual_seed(
    seed)`` and the module is then moved to ``device``; ``dtype`` is the
    compute dtype (the parameters stay float32). ``pretrained`` (a path, or
    ``True`` for the torch hub cache) loads the DLA zoo's trunk weights;
    ``freeze_base`` leaves the trunk out of the optimizer.
    """
    device = resolve_device(device)
    heads = make_heads_dict(num_classes, num_keypoints, rotated_boxes)
    module = DLASeg(heads, down_ratio=down_ratio, final_kernel=1,
                    last_level=5, head_conv=head_conv, levels=levels,
                    channels=channels, dcn_impl=dcn_impl,
                    generator=torch.Generator().manual_seed(seed),
                    dtype=dtype)
    load_backbone_pretrained(module, "dla", "dla34", pretrained)
    if freeze_base:
        freeze_trunk(module)
    return Backend(module=module.to(device), down_ratio=down_ratio,
                   rotated_boxes=rotated_boxes, num_classes=num_classes,
                   num_keypoints=num_keypoints, heads=heads, name="dla34")
