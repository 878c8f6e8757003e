"""Float32 convolutions whose gradients repeat bit for bit and stay fast.

``build_trainer`` keeps cuDNN to its deterministic algorithms, so that one
seed gives one trajectory, as the JAX package does. For some of the
float32 shapes of DLA-34 at 512 px, batch 16, cuDNN's deterministic
backward is far slower than its default, which adds with atomics, and for
others even its default is slow (``tools/conv_determinism.py`` times each
shape every way on an NVIDIA H100). ``conv2d`` gives those shapes their
gradients by routes whose sums have a fixed order:

- the data gradient of a 3x3 stride-2 conv on a map of 64 x 64 or more as
  four stride-1 forward convs (``dgrad_s2_as_s1``): the 16 -> 32 conv at
  512 px takes 1.7 ms this way, 36.0 ms by cuDNN's deterministic
  algorithm and 1.9 ms by its default;
- the weight gradient of a stride-1 conv with at most 16 input channels,
  or of a 1x1 conv on a map of 32 x 32 or more, with cuDNN off (ATen's
  im2col and GEMM, one image after the other): 16 -> 16 at 512 px 4.3 ms
  against 9.5 deterministic, 256 -> 128 1x1 at 64 px 0.4 against 2.2.

A depthwise conv that ``ops.depthwise.takes_kernel`` accepts takes its
gradients from the hand-written kernels of ``ops.depthwise`` (the forward
stays ``F.conv2d``). Every other shape, and every dtype but float32, runs
cuDNN as it is; so does any conv on the CPU, or with no gradient to take.

``ROUTES`` counts the calls of ``conv2d`` on the card with a gradient to
take by the route each took (``cudnn``, ``s1x4``, ``native_w``,
``depthwise``), at eager calls and at a CUDA graph's capture (a replay
adds nothing); ``reset_routes`` zeroes it. ``SameConv2d`` calls
``F.conv2d`` itself and is not counted.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from centernet_uda_torch.ops import depthwise

ROUTES: Dict[str, int] = {"cudnn": 0, "s1x4": 0, "native_w": 0,
                          "depthwise": 0}


def reset_routes() -> None:
    for name in ROUTES:
        ROUTES[name] = 0


def _on_card(x) -> bool:
    return x.is_cuda


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def dgrad_s2_as_s1(g: torch.Tensor, weight: torch.Tensor,
                   x_shape: Sequence[int], pad: int) -> torch.Tensor:
    """The data gradient of a stride-2 conv (dilation 1, one group,
    symmetric ``pad``) from its output's gradient ``g``: the input pixels
    of one row and column parity take ``g`` through the taps of that
    parity, so each parity class is a stride-1 forward conv of ``g`` with
    those taps, flipped and in/out transposed, written into every other
    row and column."""
    h, w = x_shape[2:]
    dx = g.new_empty(x_shape)
    wt = weight.transpose(0, 1)
    for ry in (0, 1):
        for rx in (0, 1):
            sub = wt[:, :, ry::2, rx::2].flip(2, 3).contiguous()
            nu, nv = sub.shape[2:]
            p0, q0 = (ry - pad) % 2, (rx - pad) % 2
            m0, n0 = (p0 + pad - ry) // 2, (q0 + pad - rx) // 2
            n_p, n_q = len(range(p0, h, 2)), len(range(q0, w, 2))
            full = F.conv2d(g, sub, padding=(nu - 1, nv - 1))
            # input pixels past the last window take no gradient
            full = F.pad(full, (0, max(n0 + n_q - full.shape[3], 0),
                                0, max(m0 + n_p - full.shape[2], 0)))
            dx[:, :, p0::2, q0::2] = full[:, :, m0:m0 + n_p, n0:n0 + n_q]
    return dx


def routes(x_shape, w_shape, stride, padding, dilation,
           groups) -> Tuple[bool, bool]:
    """(data gradient as four stride-1 convs, weight gradient with cuDNN
    off) for a float32 conv of these shapes."""
    (sh, sw), (ph, pw), (dh, dw) = (_pair(stride), _pair(padding),
                                    _pair(dilation))
    cout, cin, kh, kw = w_shape
    area = x_shape[2] * x_shape[3]
    plain = groups == 1 and (dh, dw) == (1, 1)
    s1x4 = (plain and (sh, sw) == (2, 2) and (kh, kw) == (3, 3)
            and ph == pw and area >= 64 * 64)
    native_w = plain and (sh, sw) == (1, 1) and (
        cin <= 16 or ((kh, kw) == (1, 1) and area >= 32 * 32))
    return s1x4, native_w


class _Conv2dFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, stride, padding, dilation, groups, s1x4,
                native_w):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, dilation, groups, s1x4, native_w)
        return F.conv2d(x, weight, None, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        stride, padding, dilation, groups, s1x4, native_w = ctx.conf
        args = (list(_pair(stride)), list(_pair(padding)),
                list(_pair(dilation)), False, [0, 0], groups)
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if s1x4:
                dx = dgrad_s2_as_s1(g, weight, x.shape, _pair(padding)[0])
            else:
                dx = torch.ops.aten.convolution_backward(
                    g, x, weight, None, *args, [True, False, False])[0]
        if ctx.needs_input_grad[1]:
            cudnn = torch.backends.cudnn
            with cudnn.flags(enabled=not native_w,
                             benchmark=cudnn.benchmark,
                             deterministic=cudnn.deterministic,
                             allow_tf32=cudnn.allow_tf32):
                dw = torch.ops.aten.convolution_backward(
                    g, x, weight, None, *args, [False, True, False])[1]
        return dx, dw, None, None, None, None, None, None


def conv2d(x: torch.Tensor, weight: torch.Tensor, stride=1, padding=0,
           dilation=1, groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` without bias; float32 on the card with a gradient to
    take goes through ``ops.depthwise`` (depthwise convs) or the routes of
    ``routes``."""
    if depthwise.takes_kernel(x, weight, stride, padding, dilation, groups):
        ROUTES["depthwise"] += 1
        return depthwise.depthwise_conv2d(x, weight, stride, padding)
    if (_on_card(x) and x.dtype == torch.float32 and torch.is_grad_enabled()
            and (x.requires_grad or weight.requires_grad)
            and not isinstance(padding, str)):
        s1x4, native_w = routes(x.shape, weight.shape, stride, padding,
                                dilation, groups)
        ROUTES["s1x4" if s1x4 else "native_w" if native_w else "cudnn"] += 1
        if s1x4 or native_w:
            return _Conv2dFn.apply(x, weight, stride, padding, dilation,
                                   groups, s1x4, native_w)
    return F.conv2d(x, weight, None, stride, padding, dilation, groups)
