"""Shared model building blocks: BatchNorm, convs, necks, heads, backend
wrapper, init, ``freeze_base``.

Counterparts of ``centernet_uda_tpu/models/common.py`` in NCHW. The heads
run per head (Conv3x3 -> ReLU -> Conv1x1), as the reference does; the JAX
package's merged-head regrouping is an exact rewrite for the TPU and is not
carried over.

Compute dtype. ``Conv2d``, ``BatchNorm2d`` and ``head`` take ``dtype``, as
flax modules do: the parameters (and BatchNorm's running statistics) stay
float32, and each layer casts its input and weights to ``dtype`` when it
runs. A convolution gives ``dtype`` out, with any bias added after its
rounding; BatchNorm takes statistics and normalises in float32 and gives
``dtype`` out. Under bfloat16 the heads compute in bf16 and the model casts
their outputs to float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from centernet_uda_torch.parallel import ddp

# torch BatchNorm2d(momentum=0.1) is flax BatchNorm(momentum=0.9)
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def bn_group_count(bn_sync, world: int) -> int:
    """The BatchNorm statistics groups over the global batch for the
    config's ``bn_sync`` (``centernet_uda_tpu/models/common.py:
    set_bn_groups``): ``global`` 1, ``replica`` one per rank, an int N."""
    if isinstance(bn_sync, str) and not bn_sync.isdigit():
        value = bn_sync.lower()
        if value == "global":
            return 1
        if value == "replica":
            return max(int(world), 1)
        raise ValueError(f"bn_sync must be 'global', 'replica' or an int, "
                         f"got {bn_sync!r}")
    return max(int(bn_sync), 1)


def set_bn_groups(module: nn.Module, groups: int) -> None:
    """Give every ``BatchNorm2d`` of ``module`` ``groups`` statistics
    groups."""
    for mod in module.modules():
        if isinstance(mod, BatchNorm2d):
            mod.groups = int(groups)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's running-statistics update.

    Training normalises with the biased batch variance, as torch does, but
    the running variance is updated with the biased variance too (flax
    ``nn.BatchNorm`` and ``centernet_uda_tpu/models/common.py``), where
    torch's own update uses the unbiased one. Statistics and normalisation
    run in float32 whatever the input's dtype (float64 for a float64
    input); the output is in ``dtype``.

    ``groups`` (``bn_sync``, set by ``set_bn_groups``) is the JAX package's
    ``GroupedBatchNorm``: training normalises each of ``groups`` contiguous
    slices of the global batch with its own moments, where ``groups``
    divides the global batch (else the whole batch is one group), and
    updates the running statistics with the pooled moments of the whole
    batch, E[var_g] + Var[mean_g]. Across ranks (``parallel/ddp.py``) the
    per-sample moments are gathered, so one group may span ranks and
    ``global`` is the moments of the global batch. Each group's variance is
    the mean of its samples' variances plus the variance of their means
    (each taken in two passes), which equals the group's biased variance
    without the one-pass E[x^2] - E[x]^2 of the JAX module. With one group
    on one device the layer is torch's own batch norm (cuDNN on the card).
    The state dict is ``nn.BatchNorm2d``'s in every case.
    """

    def __init__(self, num_features: int,
                 dtype: torch.dtype = torch.float32, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.compute_dtype = dtype
        self.groups = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps).to(self.compute_dtype)
        if self.groups > 1 or ddp.world_size() > 1:
            return self._grouped(x)
        with torch.no_grad():
            wide = x if x.dtype == torch.float64 else x.float()
            var, mean = torch.var_mean(wide, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps).to(self.compute_dtype)

    def _grouped(self, x: torch.Tensor) -> torch.Tensor:
        wide = x if x.dtype == torch.float64 else x.float()
        var, mean = torch.var_mean(wide, dim=(2, 3), correction=0)
        # (B, 2, C): every rank's per-sample moments, in global batch order
        moments = ddp.gather_rows(torch.stack((mean, var), 1))
        total = moments.shape[0]
        g = self.groups if total % self.groups == 0 else 1
        moments = moments.reshape(g, total // g, 2, -1)
        gmean = moments[:, :, 0].mean(1)  # (G, C)
        gvar = (moments[:, :, 1].mean(1)
                + (moments[:, :, 0] - gmean[:, None]).square().mean(1))
        with torch.no_grad():
            pooled_mean = gmean.mean(0)
            pooled_var = (gvar.mean(0)
                          + (gmean - pooled_mean).square().mean(0))
            dt = self.running_mean.dtype
            self.running_mean.lerp_(pooled_mean.to(dt), self.momentum)
            self.running_var.lerp_(pooled_var.to(dt), self.momentum)
            self.num_batches_tracked += 1
        first = ddp.rank() * x.shape[0]
        group = torch.arange(first, first + x.shape[0],
                             device=x.device) // (total // g)
        inv = torch.rsqrt(gvar[group] + self.eps) * self.weight  # (b, C)
        shift = self.bias - gmean[group] * inv
        return (wide * inv[:, :, None, None]
                + shift[:, :, None, None]).to(self.compute_dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` (flax ``nn.Conv(dtype=...)``):
    input and weight cast to ``dtype``, the bias added after the conv."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        if self.bias is not None:
            y = y + self.bias.to(dt).view(1, -1, 1, 1)
        return y


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: ``ceil(size / stride)``
    outputs, the total pad split with the smaller half first (so (0, 1)
    for a 3x3 stride-2 conv on an even map, (1, 1) on an odd one)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(Conv2d):
    """``Conv2d`` with XLA's ``"SAME"`` padding computed from each input's
    size (flax ``nn.Conv(padding="SAME")``; the "dynamic same" conv of
    EfficientNet-PyTorch). A symmetric pad goes to the conv itself, an
    uneven one through ``F.pad`` first."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, padding=0, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        top, bottom = same_padding(x.shape[-2], kh, sh)
        left, right = same_padding(x.shape[-1], kw, sw)
        dt = self.compute_dtype
        x = x.to(dt)
        if top == bottom and left == right:
            pad = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            pad = (0, 0)
        y = F.conv2d(x, self.weight.to(dt), None, self.stride, pad,
                     self.dilation, self.groups)
        if self.bias is not None:
            y = y + self.bias.to(dt).view(1, -1, 1, 1)
        return y


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``dtype`` (no bias). With k=4,
    stride 2, padding 1 it is flax's ``ConvTranspose(4, 2, "SAME")``, which
    pads the dilated input by 2 on each side, with the kernel the other way
    round spatially; the weight bridge flips it (``utils/weights.py``)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), None,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


def deconv_neck(in_channels: int, num_filters: Sequence[int] = (256,) * 3,
                dtype: torch.dtype = torch.float32,
                bn_eps: float = BN_EPS,
                bn_momentum: float = BN_MOMENTUM) -> nn.Sequential:
    """The deconv neck (JAX ``DeconvNeck``; the reference's
    ``_make_deconv_layer``): per stage a 4x4 stride-2 transposed conv
    without bias, BatchNorm and ReLU, flat (``deconv_layers.{3s}`` is the
    transposed conv, ``{3s + 1}`` its BatchNorm)."""
    layers: List[nn.Module] = []
    for planes in num_filters:
        layers += [ConvTranspose2d(in_channels, planes, 4, stride=2,
                                   padding=1, bias=False, dtype=dtype),
                   BatchNorm2d(planes, dtype, bn_eps, bn_momentum),
                   nn.ReLU(inplace=True)]
        in_channels = planes
    return nn.Sequential(*layers)


def upsample_conv_neck(in_channels: int,
                       num_filters: Sequence[int] = (256,) * 3,
                       dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """JAX ``UpsampleConvNeck``: per stage a nearest 2x upsample, a 3x3
    conv without bias, BatchNorm and ReLU, flat (``{4s + 1}`` the conv,
    ``{4s + 2}`` its BatchNorm)."""
    layers: List[nn.Module] = []
    for planes in num_filters:
        layers += [nn.Upsample(scale_factor=2, mode="nearest"),
                   Conv2d(in_channels, planes, 3, padding=1, bias=False,
                          dtype=dtype),
                   BatchNorm2d(planes, dtype), nn.ReLU(inplace=True)]
        in_channels = planes
    return nn.Sequential(*layers)


def lecun_normal_(param: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  fan_in: Optional[int] = None) -> None:
    """flax's default conv init: truncated normal (+-2 std) with variance
    1/fan_in, fan_in = in_channels/groups * kh * kw (a conv's layout; pass
    it for other layouts)."""
    fan_in = fan_in or param[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    # drawn on the CPU, so a seed gives the same weights on every device
    values = torch.empty(param.shape)
    nn.init.trunc_normal_(values, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    with torch.no_grad():
        param.copy_(values)


def head(in_channels: int, head_conv: int, out_channels: int,
         final_kernel: int = 1,
         dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """One prediction head: Conv3x3 -> ReLU -> Conv (state-dict keys
    ``<head>.0.*`` and ``<head>.2.*``, as in the reference)."""
    return nn.Sequential(
        Conv2d(in_channels, head_conv, 3, padding=1, bias=True, dtype=dtype),
        nn.ReLU(inplace=True),
        Conv2d(head_conv, out_channels, final_kernel,
               padding=final_kernel // 2, bias=True, dtype=dtype))


def reset_head(seq: nn.Sequential, bias_value: float = 0.0,
               generator: Optional[torch.Generator] = None) -> None:
    for conv in (seq[0], seq[2]):
        lecun_normal_(conv.weight, generator)
        nn.init.zeros_(conv.bias)
    nn.init.constant_(seq[2].bias, bias_value)


def add_heads(parent: nn.Module, heads: Dict[str, int], in_channels: int,
              head_conv: int, dtype: torch.dtype = torch.float32) -> None:
    """The JAX ``CenterNetHeads``: one ``head`` per entry of ``heads``,
    registered on ``parent`` under its name (the reference's ``hm.0``,
    ``hm.2``, ...); run them with ``apply_heads``."""
    for name in sorted(heads):
        parent.add_module(name, head(in_channels, head_conv, heads[name],
                                     dtype=dtype))


def apply_heads(parent: nn.Module, heads: Dict[str, int],
                x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The head dict of ``parent``'s heads on ``x``, in float32."""
    return {name: getattr(parent, name)(x).float() for name in heads}


def init_like_flax(module: nn.Module, heads: Dict[str, int],
                   generator: Optional[torch.Generator] = None) -> None:
    """flax's initialisation of a model without DCN, drawn from
    ``generator`` in module order: convs and transposed convs lecun-normal
    over their fan-in (16 in for a (in, out, 4, 4) transposed kernel),
    biases and BatchNorm shifts zero, BatchNorm scales one; then the heads
    (no heatmap bias)."""
    in_heads = {id(m) for h in heads for m in getattr(module, h)}
    for mod in module.modules():
        if id(mod) in in_heads:
            continue
        if isinstance(mod, BatchNorm2d):
            mod.reset_parameters()
        elif isinstance(mod, nn.ConvTranspose2d):
            lecun_normal_(mod.weight, generator,
                          fan_in=mod.weight[:, 0].numel())
        elif isinstance(mod, nn.Conv2d):
            lecun_normal_(mod.weight, generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
    for name in sorted(heads):
        reset_head(getattr(module, name), 0.0, generator)


def freeze_trunk(module: nn.Module) -> None:
    """``freeze_base``: no gradient for the trunk's parameters
    (``module.base``), as the reference sets ``requires_grad = False``
    (``backends/resnet.py:32-34``); the trainer's optimizer takes only the
    parameters that require one."""
    for p in module.base.parameters():
        p.requires_grad_(False)


def make_heads_dict(num_classes: int, num_keypoints: int,
                    rotated_boxes: bool) -> Dict[str, int]:
    """The backend head contract (reference backends/resnet.py:106-116)."""
    heads = {"hm": num_classes, "wh": 3 if rotated_boxes else 2, "reg": 2}
    if num_keypoints > 0:
        heads["kps"] = num_keypoints * 2
    return heads


@dataclass
class Backend:
    """A built backend: the ``nn.Module`` and the metadata the trainer
    reads (``forward(x) -> head dict``, ``down_ratio``, ``rotated_boxes``)."""

    module: nn.Module
    down_ratio: int
    rotated_boxes: bool
    num_classes: int
    num_keypoints: int
    heads: Dict[str, int]
    name: str = "backend"
