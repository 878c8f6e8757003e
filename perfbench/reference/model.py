"""The benchmark's frozen reference of DLA-34 CenterNet with the DCNv2 neck.

Plain PyTorch, functional: every layer reads its tensors by state-dict name
from one dict ``P``, so the same dict (made by ``perfbench/weights.py``)
loads into the program by ``load_state_dict`` and drives this reference.
It imports nothing of the program.

The model is the reference project's ``backends/dla.py`` (github.com/
scheckmedia/centernet-uda): the Deep Layer Aggregation trunk (levels
1,1,1,2,2,1; channels 16..512), the ``DLAUp``/``IDAUp`` neck whose 16
``DeformConv`` layers are DCNv2 + BatchNorm + ReLU, the depthwise
transposed-conv upsampling, and one Conv3x3-ReLU-Conv1x1 head per output.

The DCN layer follows the arithmetic that the configuration's float32 DCN
route states (the port's ``dcn_v2_twin`` semantics, which the hand-written
kernels copy from the JAX package's Pallas kernels): the vertical offset
clamped to +-14 px (a zero gradient where it saturates), horizontal
sampling exact, x and the weight rounded to bfloat16, the bilinear samples
computed in float32, times the mask, rounded to bfloat16, and contracted
in float32. The rounding of the samples rounds their gradient to bfloat16
too; x and the weight pass their gradient unrounded.

``mode`` of a forward: ``train`` (BatchNorm on batch statistics), ``eval``
(on the running statistics) or ``calib`` (as ``train``, and each layer's
batch mean and biased variance are written to ``stats``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5
MAX_SHIFT = 14.0
HM_BIAS = -2.19

# (name, shape, kind) of each state-dict entry; kind says how
# perfbench/weights.py fills it
Spec = List[Tuple[str, Tuple[int, ...], str]]


class DCNRecorder:
    """Collects ``(B, Cin, H, W, Cout)`` of every DCN layer a forward runs
    while it is active (``perfbench/counts.py`` reads it)."""

    active: Optional[List[Tuple[int, int, int, int, int]]] = None


def _conv_spec(spec: Spec, name: str, cout: int, cin: int, k: int,
               kind: str = "conv", bias: bool = False) -> None:
    spec.append((f"{name}.weight", (cout, cin, k, k), kind))
    if bias:
        spec.append((f"{name}.bias", (cout,), "zero"))


def _bn_spec(spec: Spec, name: str, c: int) -> None:
    spec += [(f"{name}.weight", (c,), "bn_weight"),
             (f"{name}.bias", (c,), "bn_bias"),
             (f"{name}.running_mean", (c,), "zero"),
             (f"{name}.running_var", (c,), "one"),
             (f"{name}.num_batches_tracked", (), "count")]


class Net:
    """DLA-34 CenterNet on one dict of tensors."""

    def __init__(self, heads: Dict[str, int], head_conv: int = 256,
                 levels: Sequence[int] = (1, 1, 1, 2, 2, 1),
                 channels: Sequence[int] = (16, 32, 64, 128, 256, 512),
                 down_ratio: int = 4):
        self.heads = dict(heads)
        self.head_conv = int(head_conv)
        self.levels = tuple(levels)
        self.channels = tuple(channels)
        self.first_level = int(math.log2(down_ratio))
        self.last_level = 5
        self.stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.checkpoint_dcn = False

    # ------------------------------------------------------------------
    # the state dict's entries, in the order the modules hold them
    # ------------------------------------------------------------------
    def spec(self) -> Spec:
        s: Spec = []
        ch, lv = self.channels, self.levels
        _conv_spec(s, "base.base_layer.0", ch[0], 3, 7)
        _bn_spec(s, "base.base_layer.1", ch[0])
        cin = ch[0]
        for i, stride in ((0, 1), (1, 2)):
            for j in range(lv[i]):
                _conv_spec(s, f"base.level{i}.{3 * j}", ch[i], cin, 3)
                _bn_spec(s, f"base.level{i}.{3 * j + 1}", ch[i])
                cin = ch[i]
        for i in range(2, 6):
            self._tree_spec(s, f"base.level{i}", lv[i], ch[i - 1], ch[i],
                            level_root=i > 2, root_dim=0)
        fl = self.first_level
        up_ch = list(ch[fl:])
        in_ch = list(up_ch)
        scales = [2 ** i for i in range(len(up_ch))]
        for i in range(len(up_ch) - 1):
            j = -i - 2
            self._ida_spec(s, f"dla_up.ida_{i}", up_ch[j], in_ch[j:],
                           [sc // scales[j] for sc in scales[j:]])
            scales[j + 1:] = [scales[j]] * len(scales[j + 1:])
            in_ch[j + 1:] = [up_ch[j]] * len(in_ch[j + 1:])
        self._ida_spec(s, "ida_up", ch[fl], list(ch[fl:self.last_level]),
                       [2 ** i for i in range(self.last_level - fl)])
        for name in sorted(self.heads):
            _conv_spec(s, f"{name}.0", self.head_conv, ch[fl], 3,
                       kind="conv", bias=True)
            s.append((f"{name}.2.weight",
                      (self.heads[name], self.head_conv, 1, 1), "head_out"))
            s.append((f"{name}.2.bias", (self.heads[name],),
                      "hm_bias" if "hm" in name else "zero"))
        return s

    def _block_spec(self, s: Spec, p: str, cin: int, cout: int) -> None:
        _conv_spec(s, f"{p}.conv1", cout, cin, 3)
        _bn_spec(s, f"{p}.bn1", cout)
        _conv_spec(s, f"{p}.conv2", cout, cout, 3)
        _bn_spec(s, f"{p}.bn2", cout)

    def _tree_spec(self, s: Spec, p: str, levels: int, cin: int, cout: int,
                   level_root: bool, root_dim: int) -> None:
        if root_dim == 0:
            root_dim = 2 * cout
        if level_root:
            root_dim += cin
        if levels == 1:
            self._block_spec(s, f"{p}.tree1", cin, cout)
            self._block_spec(s, f"{p}.tree2", cout, cout)
            _conv_spec(s, f"{p}.root.conv", cout, root_dim, 1)
            _bn_spec(s, f"{p}.root.bn", cout)
        else:
            self._tree_spec(s, f"{p}.tree1", levels - 1, cin, cout, False, 0)
            self._tree_spec(s, f"{p}.tree2", levels - 1, cout, cout, False,
                            root_dim + cout)
        if cin != cout:
            _conv_spec(s, f"{p}.project.0", cout, cin, 1)
            _bn_spec(s, f"{p}.project.1", cout)

    def _deform_spec(self, s: Spec, p: str, cin: int, cout: int) -> None:
        _bn_spec(s, f"{p}.actf.0", cout)
        s.append((f"{p}.conv.weight", (cout, cin, 3, 3), "dcn"))
        s.append((f"{p}.conv.bias", (cout,), "zero"))
        s.append((f"{p}.conv.conv_offset_mask.weight", (27, cin, 3, 3),
                  "offset"))
        s.append((f"{p}.conv.conv_offset_mask.bias", (27,), "zero"))

    def _ida_spec(self, s: Spec, p: str, o: int, chans: Sequence[int],
                  up_f: Sequence[int]) -> None:
        for i in range(1, len(chans)):
            self._deform_spec(s, f"{p}.proj_{i}", chans[i], o)
            s.append((f"{p}.up_{i}.weight", (o, 1, 2 * up_f[i], 2 * up_f[i]),
                      f"bilinear{up_f[i]}"))
            self._deform_spec(s, f"{p}.node_{i}", o, o)

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

    def conv_bn_relu(self, P, conv: str, bn: str, x, mode, stride=1,
                     padding=1):
        y = F.conv2d(x, P[f"{conv}.weight"], None, stride, padding)
        return F.relu(self.bn(P, bn, y, mode))

    def block(self, P, p, x, mode, stride=1, residual=None):
        if residual is None:
            residual = x
        out = self.conv_bn_relu(P, f"{p}.conv1", f"{p}.bn1", x, mode, stride)
        out = self.bn(P, f"{p}.bn2",
                      F.conv2d(out, P[f"{p}.conv2.weight"], None, 1, 1), mode)
        return F.relu(out + residual)

    def tree(self, P, p, levels, cin, cout, stride, level_root, x, mode,
             children=None):
        children = [] if children is None else children
        bottom = F.max_pool2d(x, stride) if stride > 1 else x
        if cin != cout:
            residual = self.bn(P, f"{p}.project.1", F.conv2d(
                bottom, P[f"{p}.project.0.weight"]), mode)
        else:
            residual = bottom
        if level_root:
            children.append(bottom)
        if levels == 1:
            x1 = self.block(P, f"{p}.tree1", x, mode, stride, residual)
            x2 = self.block(P, f"{p}.tree2", x1, mode)
            y = F.conv2d(torch.cat([x2, x1, *children], 1),
                         P[f"{p}.root.conv.weight"])
            return F.relu(self.bn(P, f"{p}.root.bn", y, mode))
        x1 = self.tree(P, f"{p}.tree1", levels - 1, cin, cout, stride, False,
                       x, mode)
        children.append(x1)
        return self.tree(P, f"{p}.tree2", levels - 1, cout, cout, 1, False,
                         x1, mode, children)

    def trunk(self, P, x, mode) -> List[torch.Tensor]:
        ch, lv = self.channels, self.levels
        x = self.conv_bn_relu(P, "base.base_layer.0", "base.base_layer.1", x,
                              mode, 1, 3)
        outs = []
        for i, stride in ((0, 1), (1, 2)):
            for j in range(lv[i]):
                x = self.conv_bn_relu(P, f"base.level{i}.{3 * j}",
                                      f"base.level{i}.{3 * j + 1}", x, mode,
                                      stride if j == 0 else 1)
            outs.append(x)
        for i in range(2, 6):
            x = self.tree(P, f"base.level{i}", lv[i], ch[i - 1], ch[i], 2,
                          i > 2, x, mode)
            outs.append(x)
        return outs

    def deform(self, P, p, x, mode):
        y = dcn(x, P[f"{p}.conv.conv_offset_mask.weight"],
                P[f"{p}.conv.conv_offset_mask.bias"], P[f"{p}.conv.weight"],
                P[f"{p}.conv.bias"], self.checkpoint_dcn)
        return F.relu(self.bn(P, f"{p}.actf.0", y, mode))

    def ida(self, P, p, layers, startp, endp, mode):
        for i in range(startp + 1, endp):
            j = i - startp
            w = P[f"{p}.up_{j}.weight"]
            f = w.shape[-1] // 2
            up = F.conv_transpose2d(self.deform(P, f"{p}.proj_{j}",
                                                layers[i], mode),
                                    w, None, f, f // 2, 0, w.shape[0])
            layers[i] = self.deform(P, f"{p}.node_{j}", up + layers[i - 1],
                                    mode)

    def forward(self, P, x: torch.Tensor, mode: str = "train"
                ) -> Dict[str, torch.Tensor]:
        layers = self.trunk(P, x, mode)
        fl = self.first_level
        out = [layers[-1]]
        for i in range(len(layers) - fl - 1):
            self.ida(P, f"dla_up.ida_{i}", layers, len(layers) - i - 2,
                     len(layers), mode)
            out.insert(0, layers[-1])
        y = list(out[:self.last_level - fl])
        self.ida(P, "ida_up", y, 0, len(y), mode)
        feat = y[-1]
        heads = {}
        for name in self.heads:
            h = F.relu(F.conv2d(feat, P[f"{name}.0.weight"],
                                P[f"{name}.0.bias"], 1, 1))
            heads[name] = F.conv2d(h, P[f"{name}.2.weight"],
                                   P[f"{name}.2.bias"])
        return heads


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 in value, its gradient passed unrounded."""
    return t + (t.to(torch.bfloat16).float() - t).detach()


def _clamp_dy(dy: torch.Tensor) -> torch.Tensor:
    return torch.where(dy.abs() < MAX_SHIFT, dy,
                       dy.clamp(-MAX_SHIFT, MAX_SHIFT).detach())


def _sample_contract(x, om, weight, bias):
    """The DCN layer from x (B, Cin, H, W) and its offset conv's output om
    (B, 27, H, W): 3x3, stride 1, padding 1."""
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    # the offset conv's channels: (o1, o2, mask logits) in thirds; the
    # offsets cat(o1, o2) hold dy of tap t in channel 2t, dx in 2t + 1
    dy_all, dx_all = om[:, 0:18:2], om[:, 1:18:2]
    mask = torch.sigmoid(om[:, 18:27])
    xs = _bf16(x).reshape(b, cin, h * w)
    rows = torch.arange(h, device=x.device, dtype=torch.float32)
    cols_ = torch.arange(w, device=x.device, dtype=torch.float32)
    taps = []
    for t in range(9):
        ty, tx = t // 3, t % 3
        py = (rows - 1 + ty).view(1, h, 1) + _clamp_dy(dy_all[:, t])
        px = (cols_ - 1 + tx).view(1, 1, w) + dx_all[:, t]
        y0, x0 = torch.floor(py), torch.floor(px)
        wy, wx = py - y0, px - x0
        val = None
        for yi, xi, wgt in ((y0, x0, (1 - wy) * (1 - wx)),
                            (y0, x0 + 1, (1 - wy) * wx),
                            (y0 + 1, x0, wy * (1 - wx)),
                            (y0 + 1, x0 + 1, wy * wx)):
            ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
            got = torch.gather(xs, 2, idx.reshape(b, 1, h * w)
                               .expand(b, cin, h * w))
            term = got * torch.where(ok, wgt, torch.zeros_like(wgt)
                                     ).reshape(b, 1, h * w)
            val = term if val is None else val + term
        val = val * mask[:, t].reshape(b, 1, h * w)
        taps.append(val.to(torch.bfloat16).float())
    cols = torch.stack(taps, 2).reshape(b, cin * 9, h * w)
    wmat = _bf16(weight).reshape(cout, cin * 9)
    out = torch.matmul(wmat, cols) + bias.view(1, cout, 1)
    return out.reshape(b, cout, h, w)


def dcn(x, om_weight, om_bias, weight, bias, use_checkpoint=False):
    """Modulated deformable 3x3 convolution with its offset conv."""
    if DCNRecorder.active is not None:
        b, cin, h, w = x.shape
        DCNRecorder.active.append((b, cin, h, w, weight.shape[0]))
    om = F.conv2d(x, om_weight, om_bias, 1, 1)
    if use_checkpoint and torch.is_grad_enabled():
        return checkpoint(_sample_contract, x, om, weight, bias,
                          use_reentrant=False)
    return _sample_contract(x, om, weight, bias)
