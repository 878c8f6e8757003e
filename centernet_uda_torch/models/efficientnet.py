"""CenterNet EfficientNet backend (b0-b8), NCHW.

Counterpart of ``centernet_uda_tpu/models/efficientnet.py`` (the
reference's ``backends/efficientnet.py`` on EfficientNet-PyTorch): MBConv
blocks with squeeze-excite and swish, compound width/depth scaling per
variant (``round_filters``, ``round_repeats``), BatchNorm with eps 1e-3 and
torch momentum 0.01, and stochastic depth at rate 0.2 * idx / blocks. The
CenterNet side: a 3-stage neck to stride 4, either 4x4 stride-2 transposed
convs or (``use_upsample``) a bilinear 4x resize then a 3x3 stride-2 conv,
each stage with BatchNorm and ReLU; with ``use_skip`` a Conv1x1 + BN + ReLU
of the block named by ``SKIP_MAPPINGS`` added to a stage's activated
output; the heads (head_conv ``num_head_channels``, no heatmap bias).

Padding as in the JAX package: the stem and the stride-2 depthwise convs
pad ``"SAME"`` from each input's size (``SameConv2d``; (1, 2) for k 5 on an
even map), the stride-1 depthwise convs (k - 1) / 2 on each side.
``jax.image.resize(..., "bilinear")`` upsampling is
``F.interpolate(mode="bilinear", align_corners=False)``.

Stochastic depth draws one Bernoulli(keep) per sample and residual block
from ``drop_generator`` (set by the trainer, ``uda/base.py``) in train
mode, and is off without one and in eval mode, as the JAX model is off
without a ``dropout`` rng. Across ranks each draws the global batch's masks
and keeps its own rows.

Module names reproduce the reference state dict: the trunk under ``base``
in EfficientNet-PyTorch's names (``base._conv_stem``, ``base._bn0``,
``base._blocks.{i}._expand_conv`` ... ``._bn2``, ``base._conv_head``,
``base._bn1``), the neck ``deconv_layers`` (3 entries a stage, or 4 with
``use_upsample``), the skips ``skip_2`` (stage 0) and ``skip_5`` (stage 1),
the heads ``hm.0.weight`` ...
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

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
from centernet_uda_torch.parallel import ddp
from centernet_uda_torch.utils.checkpoint import load_backbone_pretrained

# neck stage -> block whose output feeds its skip (stage 0 is the
# reference's flat index 2, stage 1 its 5)
SKIP_MAPPINGS = {
    "b0": {1: 4, 0: 10},
    "b1": {1: 7, 0: 15},
    "b2": {1: 7, 0: 15},
    "b3": {1: 7, 0: 17},
    "b7": {1: 17, 0: 37},
}
SKIP_NAMES = {0: "skip_2", 1: "skip_5"}

# (width_mult, depth_mult) per variant
VARIANT_PARAMS = {
    "b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
    "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1),
    "b8": (2.2, 3.6),
}

# base block args: (kernel, repeats, in, out, expand, stride)
BLOCK_ARGS = (
    (3, 1, 32, 16, 1, 1),
    (3, 2, 16, 24, 6, 2),
    (5, 2, 24, 40, 6, 2),
    (3, 3, 40, 80, 6, 2),
    (5, 3, 80, 112, 6, 1),
    (5, 4, 112, 192, 6, 2),
    (3, 1, 192, 320, 6, 1),
)
SE_RATIO = 0.25
DROP_CONNECT_RATE = 0.2
BN_EPS, BN_MOMENTUM = 1e-3, 0.01


def round_filters(filters: int, width_mult: float, divisor: int = 8) -> int:
    filters *= width_mult
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


def block_specs(variant: str) -> List[Tuple[int, int, int, int, int]]:
    """(kernel, cin, cout, expand, stride) of every MBConv block: the first
    block of each group carries the stride and the width change."""
    width, depth = VARIANT_PARAMS[variant]
    specs = []
    cin = round_filters(32, width)
    for kernel, repeats, _, cout, expand, stride in BLOCK_ARGS:
        cout = round_filters(cout, width)
        for i in range(round_repeats(repeats, depth)):
            specs.append((kernel, cin, cout, expand, stride if i == 0 else 1))
            cin = cout
    return specs


def _bn(channels: int, dtype) -> BatchNorm2d:
    return BatchNorm2d(channels, dtype, BN_EPS, BN_MOMENTUM)


def drop_connect(x: torch.Tensor, keep: float,
                 mask: torch.Tensor) -> torch.Tensor:
    """Stochastic depth of a residual branch: ``x / keep * mask``, with
    ``mask`` (B, 1, 1, 1) of zeros and ones."""
    return x / keep * mask.to(x.dtype)


class MBConv(nn.Module):
    def __init__(self, kernel: int, cin: int, cout: int, expand: int,
                 stride: int, drop_rate: float = 0.0, dtype=torch.float32):
        super().__init__()
        hidden = cin * expand
        self.use_res = stride == 1 and cin == cout
        self.drop_rate = drop_rate
        if expand != 1:
            self._expand_conv = Conv2d(cin, hidden, 1, bias=False,
                                       dtype=dtype)
            self._bn0 = _bn(hidden, dtype)
        if stride > 1:
            self._depthwise_conv = SameConv2d(hidden, hidden, kernel, stride,
                                              groups=hidden, bias=False,
                                              dtype=dtype)
        else:
            self._depthwise_conv = Conv2d(hidden, hidden, kernel,
                                          padding=(kernel - 1) // 2,
                                          groups=hidden, bias=False,
                                          dtype=dtype)
        self._bn1 = _bn(hidden, dtype)
        se_channels = max(1, int(cin * SE_RATIO))
        self._se_reduce = Conv2d(hidden, se_channels, 1, dtype=dtype)
        self._se_expand = Conv2d(se_channels, hidden, 1, dtype=dtype)
        self._project_conv = Conv2d(hidden, cout, 1, bias=False, dtype=dtype)
        self._bn2 = _bn(cout, dtype)

    def forward(self, inputs: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = inputs
        if hasattr(self, "_expand_conv"):
            x = F.silu(self._bn0(self._expand_conv(x)))
        x = F.silu(self._bn1(self._depthwise_conv(x)))
        se = x.mean((2, 3), keepdim=True)
        se = self._se_expand(F.silu(self._se_reduce(se)))
        x = torch.sigmoid(se) * x
        x = self._bn2(self._project_conv(x))
        if not self.use_res:
            return x
        if self.training and self.drop_rate > 0 and generator is not None:
            keep = 1.0 - self.drop_rate
            # the masks of the global batch, drawn alike on every rank
            # (one seed), and this rank's rows of them
            b, first = x.shape[0], ddp.rank() * x.shape[0]
            mask = torch.rand((b * ddp.world_size(), 1, 1, 1),
                              generator=generator, device=x.device)
            mask = mask[first:first + b] < keep
            x = drop_connect(x, keep, mask)
        return x + inputs


class EfficientNetTrunk(nn.Module):
    """Stem, MBConv blocks and head conv; ``forward`` returns the head
    feature and every block's output (for the skips)."""

    def __init__(self, variant: str = "b0", dtype=torch.float32):
        super().__init__()
        width, _ = VARIANT_PARAMS[variant]
        stem = round_filters(32, width)
        self._conv_stem = SameConv2d(3, stem, 3, stride=2, bias=False,
                                     dtype=dtype)
        self._bn0 = _bn(stem, dtype)
        specs = block_specs(variant)
        self._blocks = nn.ModuleList(
            MBConv(kernel, cin, cout, expand, stride,
                   DROP_CONNECT_RATE * idx / len(specs), dtype)
            for idx, (kernel, cin, cout, expand, stride) in enumerate(specs))
        self.out_channels = round_filters(1280, width)
        self._conv_head = Conv2d(specs[-1][2], self.out_channels, 1,
                                 bias=False, dtype=dtype)
        self._bn1 = _bn(self.out_channels, dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        x = F.silu(self._bn0(self._conv_stem(x)))
        feats = []
        for block in self._blocks:
            x = block(x, generator)
            feats.append(x)
        return F.silu(self._bn1(self._conv_head(x))), feats


class BilinearUp4(nn.Module):
    """``jax.image.resize`` to 4x the size, bilinear (half-pixel
    centers)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x, scale_factor=4, mode="bilinear",
                             align_corners=False)


class CenterEfficientNet(nn.Module):
    def __init__(self, variant: str, heads: Dict[str, int],
                 use_skip: bool = False, use_upsample: bool = False,
                 num_head_channels: int = 256,
                 num_deconv_channels: Sequence[int] = (256, 256, 256),
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32):
        super().__init__()
        self.heads = dict(heads)
        self.use_upsample = use_upsample
        self.base = EfficientNetTrunk(variant, dtype)
        self.drop_generator: Optional[torch.Generator] = None
        cin = self.base.out_channels
        if use_upsample:
            layers: List[nn.Module] = []
            for planes in num_deconv_channels:
                layers += [BilinearUp4(),
                           Conv2d(cin, planes, 3, stride=2, padding=1,
                                  bias=False, dtype=dtype),
                           _bn(planes, dtype), nn.ReLU(inplace=True)]
                cin = planes
            self.deconv_layers = nn.Sequential(*layers)
        else:
            self.deconv_layers = deconv_neck(cin, num_deconv_channels, dtype,
                                             BN_EPS, BN_MOMENTUM)
        cin = num_deconv_channels[-1]
        self.skip_map = SKIP_MAPPINGS.get(variant, {}) if use_skip else {}
        specs = block_specs(variant)
        for stage, block in self.skip_map.items():
            planes = num_deconv_channels[stage]
            self.add_module(SKIP_NAMES[stage], nn.Sequential(
                Conv2d(specs[block][2], planes, 1, dtype=dtype),
                _bn(planes, dtype), nn.ReLU(inplace=True)))
        add_heads(self, self.heads, cin, num_head_channels, dtype)
        init_like_flax(self, self.heads, generator)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x, feats = self.base(x, self.drop_generator)
        per_stage = 4 if self.use_upsample else 3
        for stage in range(len(self.deconv_layers) // per_stage):
            x = self.deconv_layers[per_stage * stage:
                                   per_stage * (stage + 1)](x)
            if stage in self.skip_map:
                skip = getattr(self, SKIP_NAMES[stage])
                x = skip(feats[self.skip_map[stage]]) + x
        return apply_heads(self, self.heads, x)


def build(num_classes: int, variant: str = "b0", num_keypoints: int = 0,
          pretrained=None, freeze_base: bool = False,
          rotated_boxes: bool = False, use_skip: bool = False,
          use_upsample: bool = False, num_head_channels: int = 256,
          num_deconv_channels: Optional[Sequence[int]] = None,
          dcn_impl: str = "auto", seed: int = 0, device="cuda",
          dtype=torch.float32) -> Backend:
    """Factory matching the reference signature (backends/efficientnet.py:
    203-223). Parameters are drawn on the CPU from ``torch.Generator().
    manual_seed(seed)``; ``pretrained`` (a path, or ``True`` for the torch
    hub cache) loads EfficientNet-PyTorch trunk weights; ``freeze_base``
    leaves the trunk out of the optimizer. ``dcn_impl`` is unused (no
    DCN)."""
    if variant not in VARIANT_PARAMS:
        raise NotImplementedError(
            f"EfficientNet variant {variant} is not implemented")
    device = resolve_device(device)
    heads = make_heads_dict(num_classes, num_keypoints, rotated_boxes)
    module = CenterEfficientNet(
        variant, heads, use_skip=use_skip, use_upsample=use_upsample,
        num_head_channels=num_head_channels,
        num_deconv_channels=tuple(num_deconv_channels or (256, 256, 256)),
        generator=torch.Generator().manual_seed(seed), dtype=dtype)
    name = f"efficientnet-{variant}"
    load_backbone_pretrained(module, "efficientnet", name, pretrained)
    if freeze_base:
        freeze_trunk(module)
    return Backend(module=module.to(device), down_ratio=4,
                   rotated_boxes=rotated_boxes, num_classes=num_classes,
                   num_keypoints=num_keypoints, heads=heads, name=name)
