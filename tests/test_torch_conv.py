"""The port's fixed-order convolution gradients (``ops/conv.py``) on the
CPU, in float64: the stride-2 data gradient as four stride-1 convs and the
weight gradient with cuDNN off against ATen's own, the routes each
DLA-34 float32 shape takes, and the ``Conv2d`` module on them. On the CPU
``conv2d`` is plain ``F.conv2d``; the routes are driven here through their
autograd function, and on the card by ``tests/test_torch_gpu.py``. Then
``ROUTES``, counted with the card stood in for (``_on_card``), and the
route of every conv of the benchmark's three train nets at their cells'
sizes, walked on the ``meta`` device."""

from pathlib import Path

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


def test_routes_counts_each_card_call_by_its_route(monkeypatch):
    """``ROUTES`` counts a call of ``conv2d`` on the card with a gradient to
    take by the route it took, and ``reset_routes`` zeroes it; a call with
    no gradient to take, or on the CPU, is not counted. The card is stood
    in for by ``_on_card``; the routes then run on the CPU."""
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(1, 8, 64, 64, generator=gen, requires_grad=True)
    thin = torch.randn(8, 8, 3, 3, generator=gen, requires_grad=True)
    point = torch.randn(16, 8, 1, 1, generator=gen, requires_grad=True)
    conv.reset_routes()
    conv.conv2d(x, thin, 2, 1)
    assert conv.ROUTES == dict.fromkeys(conv.ROUTES, 0)
    monkeypatch.setattr(conv, "_on_card", lambda t: True)
    conv.conv2d(x, thin, 2, 1)  # s1x4: 3x3 stride 2 on 64 x 64
    conv.conv2d(x, point, 1, 0)  # native_w: 1x1 on 64 x 64
    conv.conv2d(x, point, 1, 0)
    conv.conv2d(x, thin, 1, 2, 2)  # cuDNN: dilated
    with torch.no_grad():
        conv.conv2d(x, thin, 1, 1)
    conv.conv2d(x.detach(), thin.detach(), 1, 1)
    assert conv.ROUTES == {"cudnn": 1, "s1x4": 1, "native_w": 2,
                           "depthwise": 0}
    conv.reset_routes()
    assert conv.ROUTES == dict.fromkeys(conv.ROUTES, 0)


# each route's calls in one train-mode forward of the benchmark's train
# cells' nets at 512 px and their batches (SameConv2d calls F.conv2d and is
# not counted: ResNet's three stride-2 3x3 convs and b3's four stride-2
# depthwise convs)
NET_ROUTES = {
    "rotated": (16, {"cudnn": 42, "s1x4": 0, "native_w": 65,
                     "depthwise": 0}),
    "baseline": (16, {"cudnn": 26, "s1x4": 4, "native_w": 15,
                      "depthwise": 0}),
    "coco_merged": (8, {"cudnn": 63, "s1x4": 0, "native_w": 50,
                        "depthwise": 22}),
}


@pytest.mark.parametrize("experiment", sorted(NET_ROUTES))
def test_route_of_every_conv_of_the_benchmarks_nets(experiment,
                                                    monkeypatch):
    """ResNet-101 (``rotated``), DLA-34 (``baseline``) and
    EfficientNet-b3 (``coco_merged``) in float32, built on the ``meta``
    device (shapes only) with the card stood in for, one train-mode forward
    at 512 px: the count of each route. ResNet-101's weight gradients of
    its stride-1 1x1 convs on maps of 32 x 32 or more leave cuDNN (46 in
    stage 3's 23 blocks, 65 in all with the heads' 1x1 convs); no conv of
    it takes ``s1x4``, since its stride-2 3x3 convs pad "SAME" in
    ``SameConv2d``. DLA-34's and b3's counts pin their cells' routes."""
    from centernet_uda_torch import models
    from centernet_uda_torch.config import compose
    from centernet_uda_torch.models.common import SameConv2d
    from centernet_uda_torch.ops import depthwise

    batch, want = NET_ROUTES[experiment]
    root = Path(__file__).resolve().parents[1]
    cfg = compose([f"experiment={experiment}", "precision=float32"],
                  config_dir=str(root / "configs"))
    params = {**cfg.model.backend.params.to_dict(), "device": "meta",
              "dcn_impl": "xla"}
    net = models.build(cfg.model.backend.name, **params).module.train()
    monkeypatch.setattr(conv, "_on_card", lambda t: True)
    monkeypatch.setattr(depthwise, "_on_card", lambda t: True)
    conv.reset_routes()
    net(torch.zeros(batch, 3, 512, 512, device="meta"))
    got = dict(conv.ROUTES)
    conv.reset_routes()
    assert got == want
    if experiment == "rotated":
        same = [m for m in net.modules() if isinstance(m, SameConv2d)]
        assert len(same) == 3
        assert sum(isinstance(m, torch.nn.Conv2d) for m in net.modules()) \
            == sum(want.values()) + len(same)
