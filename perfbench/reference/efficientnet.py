"""The benchmark's frozen reference of EfficientNet CenterNet.

Plain PyTorch, functional: every layer reads its tensors by state-dict name
from one dict ``P``, so the same dict (made by ``perfbench/weights.py``)
loads into the program by ``load_state_dict`` and drives this reference.
It imports nothing of the program.

The model is the reference project's ``backends/efficientnet.py``
(github.com/scheckmedia/centernet-uda), whose trunk is EfficientNet-PyTorch
(github.com/lukemelas/EfficientNet-PyTorch), written out from the published
description:

- the trunk: a 3x3 stride-2 stem, the MBConv blocks of the base table
  (kernel, repeats, filters in and out, expansion, stride) scaled by the
  variant's width and depth (``round_filters``: the width times the
  filters, to a multiple of 8 no smaller than 90 % of it; ``round_repeats``:
  the ceiling of the depth times the repeats), and a 1x1 head conv to
  ``round_filters(1280)``; BatchNorm with eps 1e-3 after every conv, swish
  after the stem, the expansion, the depthwise conv and the head conv;
- an MBConv block: a 1x1 expansion (none where the expansion is 1), the
  depthwise conv, squeeze-excite (the spatial mean, a 1x1 conv with bias
  to ``max(1, int(cin * 0.25))`` channels, swish, a 1x1 conv with bias
  back, a sigmoid gate), a 1x1 projection; where the stride is 1 and the
  width does not change, stochastic depth at the rate ``0.2 * idx /
  blocks`` and the identity added;
- padding: EfficientNet-PyTorch's static "same", from each layer's input
  size: the total pad ``max((ceil(n / s) - 1) * s + k - n, 0)``, its
  smaller half first (on an even map a stride-2 conv pads (0, 1) for
  3x3, (1, 2) for 5x5; a stride-1 conv (k - 1) / 2 on each side);
- the CenterNet side: three 4x4 stride-2 transposed convs without bias
  (padding 1), each with BatchNorm and ReLU; with ``use_skip`` a 1x1 conv
  with bias, BatchNorm and ReLU of the output of the block the skip table
  names, added to the stage's activated output (stage 1 first, as the
  table lists it); one Conv3x3-ReLU-Conv1x1 head per output, each conv
  with bias.

Stochastic depth as the program draws it (``uda/base.py``,
``models/efficientnet.py``): with ``step`` given, in a train or ``calib``
forward, one ``torch.rand`` of (B, 1, 1, 1) a residual block whose rate is
above 0, in block order, from a generator on the input's device seeded
with ``((seed + 7919) * 1_000_003 + step) mod 2**63``, ``seed`` being the
composed configuration's (the ``reference`` section's ``seed``); a row is
kept where the draw is under ``keep = 1 - rate``, and the branch is
``x / keep * mask``. Without ``step`` nothing is drawn and nothing dropped.

Departures from the published description:

- EfficientNet-PyTorch keeps a row where ``floor(keep + r) = 1``, i.e.
  ``r >= 1 - keep``; the program keeps it where ``r < keep``. The two are
  the same distribution but keep other rows for the same draw, so this
  reference follows the program's rule.
- BatchNorm's running statistics move at torch's momentum 0.01 (the
  reference project's 1 - 0.99) with the biased batch variance, as the
  port's BatchNorm moves them (torch's own layer takes the unbiased one).
  The harness folds ``stats`` into running statistics at torch's default
  0.1 (``check._fold_running``); so in a ``calib`` forward under autograd
  (a judged train step) each layer records, in place of its batch
  statistics, the point that a 0.1 step must aim at to move as a 0.01
  step does: ``running + (0.01 / 0.1) * (batch - running)``. Without
  autograd (``weights.calibrate``) it records the batch statistics.

``mode`` of a forward: ``train`` (BatchNorm on batch statistics), ``eval``
(on the running statistics) or ``calib`` (as ``train``, and each layer's
statistics are written to ``stats``, as above).

The net's contract with the harness (``perfbench/check.py:make_net``):
``build(reference)`` from the configuration's ``reference`` section;
``spec()``, ``stats``, ``forward(P, x, mode, step=None)``, the
``checkpoint`` switch (ignored: the net keeps its activations) and
``dcn_shapes`` (the net has no DCN and appends nothing).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
BN_MOMENTUM = 0.01  # torch's convention: the weight of the new statistics
HARNESS_MOMENTUM = 0.1  # the momentum check._fold_running folds at
SE_RATIO = 0.25
DROP_RATE = 0.2
SEED_OFFSET, SEED_STRIDE = 7919, 1_000_003

# (width, depth) of each variant
VARIANTS = {
    "b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
    "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1),
    "b8": (2.2, 3.6),
}
# the base table: (kernel, repeats, filters in, filters out, expansion,
# stride) of each group of blocks
BASE_BLOCKS = (
    (3, 1, 32, 16, 1, 1),
    (3, 2, 16, 24, 6, 2),
    (5, 2, 24, 40, 6, 2),
    (3, 3, 40, 80, 6, 2),
    (5, 3, 80, 112, 6, 1),
    (5, 4, 112, 192, 6, 2),
    (3, 1, 192, 320, 6, 1),
)
# the reference project's skips: (neck stage, block whose output feeds it),
# stage 1 first; the stage's module is skip_5 (stage 1) or skip_2 (stage 0)
SKIPS = {
    "b0": ((1, 4), (0, 10)),
    "b1": ((1, 7), (0, 15)),
    "b2": ((1, 7), (0, 15)),
    "b3": ((1, 7), (0, 17)),
    "b7": ((1, 17), (0, 37)),
}
SKIP_NAMES = {0: "skip_2", 1: "skip_5"}

Spec = List[Tuple[str, Tuple[int, ...], str]]


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    scaled = filters * width
    out = max(divisor, int(scaled + divisor / 2) // divisor * divisor)
    if out < 0.9 * scaled:
        out += divisor
    return int(out)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def blocks(variant: str) -> List[Tuple[int, int, int, int, int]]:
    """(kernel, cin, cout, expansion, stride) of every block: the first of
    a group takes the group's stride and width change."""
    width, depth = VARIANTS[variant]
    out = []
    cin = round_filters(32, width)
    for kernel, repeats, _, cout, expand, stride in BASE_BLOCKS:
        cout = round_filters(cout, width)
        for i in range(round_repeats(repeats, depth)):
            out.append((kernel, cin, cout, expand, stride if i == 0 else 1))
            cin = cout
    return out


def same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """Static "same" padding of one spatial dim: the smaller half first."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv_spec(spec: Spec, name: str, cout: int, cin: int, k: int,
               bias: bool = False) -> None:
    spec.append((f"{name}.weight", (cout, cin, k, k), "conv"))
    if bias:
        spec.append((f"{name}.bias", (cout,), "zero"))


def _bn_spec(spec: Spec, name: str, c: int) -> None:
    spec += [(f"{name}.weight", (c,), "bn_weight"),
             (f"{name}.bias", (c,), "bn_bias"),
             (f"{name}.running_mean", (c,), "zero"),
             (f"{name}.running_var", (c,), "one"),
             (f"{name}.num_batches_tracked", (), "count")]


def build(reference: dict) -> "Net":
    """The net of a configuration's ``reference`` section (``backend``'s
    ``variant``, ``heads``, ``head_conv``, ``deconv_channels``,
    ``use_skip``, ``seed``)."""
    return Net(reference["backend"]["variant"], reference["heads"],
               reference["head_conv"], reference["deconv_channels"],
               reference["use_skip"], reference["seed"])


class Net:
    """EfficientNet CenterNet on one dict of tensors."""

    def __init__(self, variant: str, heads: Dict[str, int],
                 head_conv: int = 256,
                 deconv_channels: Sequence[int] = (256, 256, 256),
                 use_skip: bool = True, seed: int = 42):
        self.variant = variant
        self.heads = dict(heads)
        self.head_conv = int(head_conv)
        self.deconv_channels = tuple(deconv_channels)
        self.blocks = blocks(variant)
        self.skips = SKIPS.get(variant, ()) if use_skip else ()
        self.seed = int(seed)
        self.stem = round_filters(32, VARIANTS[variant][0])
        self.top = round_filters(1280, VARIANTS[variant][0])
        self.stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.checkpoint = False
        self.dcn_shapes: Optional[List[Tuple[int, int, int, int, int]]] = None

    def drop_rate(self, idx: int) -> float:
        return DROP_RATE * idx / len(self.blocks)

    # ------------------------------------------------------------------
    # the state dict's entries, in the order the modules hold them
    # ------------------------------------------------------------------
    def spec(self) -> Spec:
        s: Spec = []
        _conv_spec(s, "base._conv_stem", self.stem, 3, 3)
        _bn_spec(s, "base._bn0", self.stem)
        for i, (k, cin, cout, expand, _) in enumerate(self.blocks):
            p = f"base._blocks.{i}"
            hidden = cin * expand
            if expand != 1:
                _conv_spec(s, f"{p}._expand_conv", hidden, cin, 1)
                _bn_spec(s, f"{p}._bn0", hidden)
            _conv_spec(s, f"{p}._depthwise_conv", hidden, 1, k)
            _bn_spec(s, f"{p}._bn1", hidden)
            se = max(1, int(cin * SE_RATIO))
            _conv_spec(s, f"{p}._se_reduce", se, hidden, 1, bias=True)
            _conv_spec(s, f"{p}._se_expand", hidden, se, 1, bias=True)
            _conv_spec(s, f"{p}._project_conv", cout, hidden, 1)
            _bn_spec(s, f"{p}._bn2", cout)
        _conv_spec(s, "base._conv_head", self.top, self.blocks[-1][2], 1)
        _bn_spec(s, "base._bn1", self.top)
        cin = self.top
        for stage, planes in enumerate(self.deconv_channels):
            # a transposed conv's weight is (in, out, kh, kw)
            s.append((f"deconv_layers.{3 * stage}.weight", (cin, planes, 4, 4),
                      "conv"))
            _bn_spec(s, f"deconv_layers.{3 * stage + 1}", planes)
            cin = planes
        for stage, block in self.skips:
            name = SKIP_NAMES[stage]
            planes = self.deconv_channels[stage]
            _conv_spec(s, f"{name}.0", planes, self.blocks[block][2], 1,
                       bias=True)
            _bn_spec(s, f"{name}.1", planes)
        for name in sorted(self.heads):
            _conv_spec(s, f"{name}.0", self.head_conv, cin, 3, bias=True)
            s.append((f"{name}.2.weight",
                      (self.heads[name], self.head_conv, 1, 1), "head_out"))
            s.append((f"{name}.2.bias", (self.heads[name],),
                      "hm_bias" if "hm" in name else "zero"))
        return s

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def bn(self, P, p: str, x: torch.Tensor, mode: str) -> torch.Tensor:
        if mode == "eval":
            return F.batch_norm(x, P[f"{p}.running_mean"],
                                P[f"{p}.running_var"], P[f"{p}.weight"],
                                P[f"{p}.bias"], False, 0.0, BN_EPS)
        if mode == "calib":
            judged = torch.is_grad_enabled()
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
                if judged:
                    # a judged train step: see the module's docstring
                    scale = BN_MOMENTUM / HARNESS_MOMENTUM
                    rm = P[f"{p}.running_mean"].double()
                    rv = P[f"{p}.running_var"].double()
                    mean = rm + scale * (mean.double() - rm)
                    var = rv + scale * (var.double() - rv)
            self.stats[p] = (mean, var)
        return F.batch_norm(x, None, None, P[f"{p}.weight"], P[f"{p}.bias"],
                            True, 0.0, BN_EPS)

    def conv(self, P, name: str, x: torch.Tensor, stride: int = 1,
             groups: int = 1, bias: bool = False) -> torch.Tensor:
        """A conv of ``P[name.weight]`` padded static "same" from the
        input's size (an uneven pad by ``F.pad`` first); the bias added
        after it."""
        w = P[f"{name}.weight"]
        top, bottom = same_pad(x.shape[-2], w.shape[-2], stride)
        left, right = same_pad(x.shape[-1], w.shape[-1], stride)
        if top == bottom and left == right:
            padding = top
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = 0
        y = F.conv2d(x, w, None, stride, padding, 1, groups)
        if bias:
            y = y + P[f"{name}.bias"].view(1, -1, 1, 1)
        return y

    def mbconv(self, P, idx: int, x: torch.Tensor, mode: str,
               gen: Optional[torch.Generator]) -> torch.Tensor:
        _, cin, cout, expand, stride = self.blocks[idx]
        p = f"base._blocks.{idx}"
        inputs = x
        if expand != 1:
            x = F.silu(self.bn(P, f"{p}._bn0",
                               self.conv(P, f"{p}._expand_conv", x), mode))
        x = self.conv(P, f"{p}._depthwise_conv", x, stride,
                      groups=x.shape[1])
        x = F.silu(self.bn(P, f"{p}._bn1", x, mode))
        se = x.mean((2, 3), keepdim=True)
        se = self.conv(P, f"{p}._se_expand",
                       F.silu(self.conv(P, f"{p}._se_reduce", se,
                                        bias=True)), bias=True)
        x = torch.sigmoid(se) * x
        x = self.bn(P, f"{p}._bn2", self.conv(P, f"{p}._project_conv", x),
                    mode)
        if stride != 1 or cin != cout:
            return x
        rate = self.drop_rate(idx)
        if gen is not None and rate > 0:
            keep = 1.0 - rate
            draw = torch.rand((x.shape[0], 1, 1, 1), generator=gen,
                              device=x.device)
            x = x / keep * (draw < keep).to(x.dtype)
        return x + inputs

    def drop_generator(self, device, step: int) -> torch.Generator:
        """The program's stochastic-depth generator at ``step``."""
        gen = torch.Generator(device=device)
        gen.manual_seed(((self.seed + SEED_OFFSET) * SEED_STRIDE + int(step))
                        % (2 ** 63))
        return gen

    def forward(self, P, x: torch.Tensor, mode: str = "train",
                step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        gen = (self.drop_generator(x.device, step)
               if mode != "eval" and step is not None else None)
        x = F.silu(self.bn(P, "base._bn0",
                           self.conv(P, "base._conv_stem", x, 2), mode))
        feats = []
        for idx in range(len(self.blocks)):
            x = self.mbconv(P, idx, x, mode, gen)
            feats.append(x)
        x = F.silu(self.bn(P, "base._bn1",
                           self.conv(P, "base._conv_head", x), mode))
        skips = dict(self.skips)
        for stage in range(len(self.deconv_channels)):
            x = F.conv_transpose2d(x, P[f"deconv_layers.{3 * stage}.weight"],
                                   None, 2, 1)
            x = F.relu(self.bn(P, f"deconv_layers.{3 * stage + 1}", x, mode))
            if stage in skips:
                name = SKIP_NAMES[stage]
                y = self.conv(P, f"{name}.0", feats[skips[stage]], bias=True)
                x = F.relu(self.bn(P, f"{name}.1", y, mode)) + x
        heads = {}
        for name in self.heads:
            h = F.relu(self.conv(P, f"{name}.0", x, bias=True))
            heads[name] = self.conv(P, f"{name}.2", h, bias=True)
        return heads
