"""The benchmark's frozen reference of ResNet CenterNet.

Plain PyTorch, functional: every layer reads its tensors by state-dict name
from one dict ``P``, so the same dict (made by ``perfbench/weights.py``)
loads into the program by ``load_state_dict`` and drives this reference.
It imports nothing of the program.

The model is the reference project's ``backends/resnet.py``
(github.com/scheckmedia/centernet-uda), whose trunk is torchvision's
ResNet-v1 (He et al., arXiv:1512.03385) without its average pool and fc,
under CenterNet's deconv neck (the "simple baselines" neck of
arXiv:1804.06208), written out from the published description:

- the trunk, ``base``: a 7x7 stride-2 conv to 64 (padding 3), BatchNorm,
  ReLU, a 3x3 stride-2 max pool (padding 1), then four stages of blocks
  (``base.4`` to ``base.7``) of 64, 128, 256 and 512 planes, the first
  block of stages 2-4 of stride 2; each block a Bottleneck (a 1x1 conv to
  the planes, a 3x3 conv of the block's stride, a 1x1 conv to 4 x the
  planes, each with BatchNorm, ReLU after the first two, the identity or
  a downsample of a strided 1x1 conv and BatchNorm added before the last
  ReLU): 3, 4, 23, 3 blocks for ResNet-101 (ResNet-50 and -152 by their
  own counts; the BasicBlock nets, ResNet-18 and -34, are not written
  out); no conv has a bias;
- the neck: three 4x4 stride-2 transposed convs without bias (padding 1)
  to 256 channels, each with BatchNorm and ReLU
  (``deconv_layers.{3s}``, ``{3s + 1}``);
- one Conv3x3-ReLU-Conv1x1 head per output (``hm``, ``wh``, ``reg``,
  ``head_conv`` wide), each conv with a bias, added after the conv;
- BatchNorm: eps 1e-5; the running statistics move at torch's momentum
  0.1, the harness's own (``check._fold_running``).

Departures from the published description:

- The stride-2 3x3 convs pad "SAME", computed from each input's size:
  the total pad ``max((ceil(n / 2) - 1) * 2 + 3 - n, 0)``, its smaller
  half first, so (0, 1) on an even map and (1, 1) on an odd one, where
  torchvision pads (1, 1) always. The program pads so (``models/
  resnet.py``, ``SameConv2d``, after the JAX package), and this reference
  follows the program. ``padding = "torchvision"`` on a net pads (1, 1)
  as torchvision does (the tests' fault).
- BatchNorm's running variance moves with the biased batch variance, as
  the port's BatchNorm moves it (torch's own layer takes the unbiased
  one).

``mode`` of a forward: ``train`` (BatchNorm on batch statistics), ``eval``
(on the running statistics) or ``calib`` (as ``train``, and each layer's
batch mean and biased variance are written to ``stats``).

The net's contract with the harness (``perfbench/check.py:make_net``):
``build(reference)`` from the configuration's ``reference`` section;
``spec()``, ``stats``, ``forward(P, x, mode, step=None)`` (ResNet draws
nothing per step and ignores ``step``), the ``checkpoint`` switch
(ignored: the net keeps its activations) and ``dcn_shapes`` (the net has
no DCN and appends nothing).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
# num_layers -> Bottleneck blocks a stage
DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
PLANES = (64, 128, 256, 512)
EXPANSION = 4
STEM = 64

Spec = List[Tuple[str, Tuple[int, ...], str]]


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
    ``num_layers``, ``heads``, ``head_conv``, ``deconv_channels``)."""
    return Net(reference["backend"]["num_layers"], reference["heads"],
               reference["head_conv"], reference["deconv_channels"])


class Net:
    """ResNet CenterNet on one dict of tensors."""

    def __init__(self, num_layers: int, heads: Dict[str, int],
                 head_conv: int = 64,
                 deconv_channels: Sequence[int] = (256, 256, 256)):
        self.depths = DEPTHS[int(num_layers)]
        self.heads = dict(heads)
        self.head_conv = int(head_conv)
        self.deconv_channels = tuple(deconv_channels)
        self.padding = "same"
        self.stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.checkpoint = False
        self.dcn_shapes: Optional[List[Tuple[int, int, int, int, int]]] = None

    def blocks(self) -> List[Tuple[str, int, int, int]]:
        """(name, cin, planes, stride) of every block, in order."""
        out, cin = [], STEM
        for stage, (planes, n) in enumerate(zip(PLANES, self.depths)):
            for i in range(n):
                stride = 2 if stage > 0 and i == 0 else 1
                out.append((f"base.{4 + stage}.{i}", cin, planes, stride))
                cin = planes * EXPANSION
        return out

    # ------------------------------------------------------------------
    # the state dict's entries, in the order the modules hold them
    # ------------------------------------------------------------------
    def spec(self) -> Spec:
        s: Spec = []
        _conv_spec(s, "base.0", STEM, 3, 7)
        _bn_spec(s, "base.1", STEM)
        for p, cin, planes, stride in self.blocks():
            _conv_spec(s, f"{p}.conv1", planes, cin, 1)
            _bn_spec(s, f"{p}.bn1", planes)
            _conv_spec(s, f"{p}.conv2", planes, planes, 3)
            _bn_spec(s, f"{p}.bn2", planes)
            _conv_spec(s, f"{p}.conv3", planes * EXPANSION, planes, 1)
            _bn_spec(s, f"{p}.bn3", planes * EXPANSION)
            if stride != 1 or cin != planes * EXPANSION:
                _conv_spec(s, f"{p}.downsample.0", planes * EXPANSION, cin, 1)
                _bn_spec(s, f"{p}.downsample.1", planes * EXPANSION)
        cin = PLANES[-1] * EXPANSION
        for stage, planes in enumerate(self.deconv_channels):
            # a transposed conv's weight is (in, out, kh, kw)
            s.append((f"deconv_layers.{3 * stage}.weight", (cin, planes, 4, 4),
                      "conv"))
            _bn_spec(s, f"deconv_layers.{3 * stage + 1}", planes)
            cin = planes
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
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.stats[p] = (mean, var)
        return F.batch_norm(x, None, None, P[f"{p}.weight"], P[f"{p}.bias"],
                            True, 0.0, BN_EPS)

    def conv3x3(self, P, name: str, x: torch.Tensor,
                stride: int) -> torch.Tensor:
        """A 3x3 conv without bias: padding 1 at stride 1; at stride 2
        static "same" from the input's size (an uneven pad by ``F.pad``
        first), or (1, 1) where the net pads as torchvision."""
        w = P[f"{name}.weight"]
        if stride == 1 or self.padding == "torchvision":
            return F.conv2d(x, w, None, stride, 1)
        top, bottom = same_pad(x.shape[-2], 3, stride)
        left, right = same_pad(x.shape[-1], 3, stride)
        if top == bottom and left == right:
            return F.conv2d(x, w, None, stride, top)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, w, None, stride, 0)

    def block(self, P, p: str, x: torch.Tensor, cin: int, planes: int,
              stride: int, mode: str) -> torch.Tensor:
        y = F.relu(self.bn(P, f"{p}.bn1",
                           F.conv2d(x, P[f"{p}.conv1.weight"]), mode))
        y = F.relu(self.bn(P, f"{p}.bn2",
                           self.conv3x3(P, f"{p}.conv2", y, stride), mode))
        y = self.bn(P, f"{p}.bn3", F.conv2d(y, P[f"{p}.conv3.weight"]), mode)
        if stride != 1 or cin != planes * EXPANSION:
            x = self.bn(P, f"{p}.downsample.1",
                        F.conv2d(x, P[f"{p}.downsample.0.weight"], None,
                                 stride), mode)
        return F.relu(y + x)

    def forward(self, P, x: torch.Tensor, mode: str = "train",
                step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        x = F.conv2d(x, P["base.0.weight"], None, 2, 3)
        x = F.relu(self.bn(P, "base.1", x, mode))
        x = F.max_pool2d(x, 3, 2, 1)
        for p, cin, planes, stride in self.blocks():
            x = self.block(P, p, x, cin, planes, stride, mode)
        for stage in range(len(self.deconv_channels)):
            x = F.conv_transpose2d(x, P[f"deconv_layers.{3 * stage}.weight"],
                                   None, 2, 1)
            x = F.relu(self.bn(P, f"deconv_layers.{3 * stage + 1}", x, mode))
        heads = {}
        for name in self.heads:
            h = F.relu(F.conv2d(x, P[f"{name}.0.weight"], None, 1, 1)
                       + P[f"{name}.0.bias"].view(1, -1, 1, 1))
            heads[name] = (F.conv2d(h, P[f"{name}.2.weight"])
                           + P[f"{name}.2.bias"].view(1, -1, 1, 1))
        return heads
