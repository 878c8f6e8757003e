"""The port's fixed-order convolution gradients (``ops/conv.py``) on the
CPU, in float64: the stride-2 data gradient as four stride-1 convs and the
weight gradient with cuDNN off against ATen's own, the routes each
DLA-34 float32 shape takes, and the ``Conv2d`` module on them. On the CPU
``conv2d`` is plain ``F.conv2d``; the routes are driven here through their
autograd function, and on the card by ``tests/test_torch_gpu.py``."""

import pytest
import torch
import torch.nn.functional as F

from centernet_uda_torch.models.common import Conv2d
from centernet_uda_torch.ops import conv


def _aten_grads(g, x, w, stride, pad):
    return torch.ops.aten.convolution_backward(
        g, x, w, None, [stride, stride], [pad, pad], [1, 1], False, [0, 0],
        1, [True, True, False])[:2]


@pytest.mark.parametrize("h, w_, k, pad", [
    (16, 16, 3, 1), (15, 17, 3, 1), (16, 16, 3, 0), (13, 12, 5, 2),
    (12, 12, 7, 3), (64, 64, 3, 1)])
def test_stride2_data_gradient_as_four_stride1_convs(h, w_, k, pad):
    gen = torch.Generator().manual_seed(h * 100 + k)
    x = torch.randn(2, 5, h, w_, dtype=torch.float64, generator=gen)
    w = torch.randn(7, 5, k, k, dtype=torch.float64, generator=gen)
    g = torch.randn(F.conv2d(x, w, None, 2, pad).shape, dtype=torch.float64,
                    generator=gen)
    want = _aten_grads(g, x, w, 2, pad)[0]
    got = conv.dgrad_s2_as_s1(g, w, x.shape, pad)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("stride, k, s1x4, native_w", [
    (2, 3, True, False), (1, 3, False, True), (1, 1, False, True),
    (2, 3, True, True)])
def test_autograd_function_gives_atens_gradients(stride, k, s1x4, native_w):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 6, 18, 18, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    w = torch.randn(4, 6, k, k, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    pad = k // 2
    y = conv._Conv2dFn.apply(x, w, stride, pad, 1, 1, s1x4, native_w)
    torch.testing.assert_close(y, F.conv2d(x, w, None, stride, pad),
                               rtol=0, atol=0)
    g = torch.randn(y.shape, dtype=torch.float64, generator=gen)
    got = torch.autograd.grad(y, (x, w), g)
    want = _aten_grads(g, x.detach(), w.detach(), stride, pad)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_only_the_weight_gradient_when_the_input_needs_none():
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(1, 3, 20, 20, dtype=torch.float64, generator=gen)
    w = torch.randn(4, 3, 3, 3, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    y = conv._Conv2dFn.apply(x, w, 2, 1, 1, 1, True, True)
    (dw,) = torch.autograd.grad(y.square().sum(), (w,))
    want = torch.autograd.grad(F.conv2d(x, w, None, 2, 1).square().sum(),
                               (w,))[0]
    torch.testing.assert_close(dw, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("x_shape, w_shape, stride, want", [
    # DLA-34 at 512 px, batch 16: the strided convs of the base
    ((16, 16, 512, 512), (32, 16, 3, 3), 2, (True, False)),
    ((16, 64, 128, 128), (128, 64, 3, 3), 2, (True, False)),
    ((16, 256, 32, 32), (512, 256, 3, 3), 2, (False, False)),
    # thin convs at full resolution, the stem
    ((16, 16, 512, 512), (16, 16, 3, 3), 1, (False, True)),
    ((16, 3, 512, 512), (16, 3, 7, 7), 1, (False, True)),
    # 1x1 convs from 32 x 32 up, not below
    ((16, 256, 64, 64), (128, 256, 1, 1), 1, (False, True)),
    ((16, 256, 16, 16), (512, 256, 1, 1), 1, (False, False)),
    # cuDNN as it is
    ((16, 64, 128, 128), (64, 64, 3, 3), 1, (False, False)),
    ((16, 64, 128, 128), (27, 64, 3, 3), 1, (False, False))])
def test_routes_of_dla34_shapes(x_shape, w_shape, stride, want):
    pad = w_shape[-1] // 2
    assert conv.routes(x_shape, w_shape, stride, pad, 1, 1) == want


def test_routes_leave_grouped_and_dilated_convs_to_cudnn():
    assert conv.routes((2, 16, 128, 128), (16, 1, 3, 3), 2, 1, 1,
                       16) == (False, False)
    assert conv.routes((2, 16, 128, 128), (16, 16, 3, 3), 1, 2, 2,
                       1) == (False, False)


def test_conv2d_on_the_cpu_is_plain_conv2d():
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 16, 64, 64, generator=gen, requires_grad=True)
    w = torch.randn(32, 16, 3, 3, generator=gen, requires_grad=True)
    y = conv.conv2d(x, w, 2, 1)
    assert "ConvolutionBackward" in type(y.grad_fn).__name__
    torch.testing.assert_close(y, F.conv2d(x, w, None, 2, 1), rtol=0,
                               atol=0)


def test_conv2d_module_matches_nn_conv2d():
    torch.manual_seed(6)
    mod = Conv2d(8, 12, 3, 2, 1, bias=True)
    ref = torch.nn.Conv2d(8, 12, 3, 2, 1, bias=True)
    ref.load_state_dict(mod.state_dict())
    x = torch.randn(2, 8, 17, 17)
    torch.testing.assert_close(mod(x), ref(x), rtol=1e-6, atol=1e-6)
