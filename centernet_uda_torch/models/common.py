"""Shared model building blocks: BatchNorm, heads, backend wrapper, init.

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
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# torch BatchNorm2d(momentum=0.1) is flax BatchNorm(momentum=0.9)
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's running-statistics update.

    Training normalises with the biased batch variance, as torch does, but
    the running variance is updated with the biased variance too (flax
    ``nn.BatchNorm`` and ``centernet_uda_tpu/models/common.py``), where
    torch's own update uses the unbiased one. Statistics and normalisation
    run in float32 whatever the input's dtype; the output is in ``dtype``.
    """

    def __init__(self, num_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps).to(self.compute_dtype)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps).to(self.compute_dtype)


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
