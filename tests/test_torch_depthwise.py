"""The depthwise conv's backward (``ops.depthwise``) on the CPU: the plain
twin against float64 autograd of ``F.conv2d``, which convs take the route,
the autograd Function on its twin against ATen's gradients, and the
kernels' names in the benchmark's depthwise family.

The kernels run only on the card (``tests/test_torch_gpu.py``) and, built
for the CPU, in ``tests/test_torch_emulated_kernels.py``. Here the CPU
stands in for the card where a test says so: the rule's device check is
replaced by one that accepts CPU tensors, and the Function then runs its
twin.

Tolerance of the twin: it sums in float32, in another order than
autograd's float64, over at most a few hundred products: 1e-5 of the
largest value, relative and absolute.
"""

import pytest
import torch
import torch.nn.functional as F

from centernet_uda_torch.models import dla, efficientnet, mobilenetv2
from centernet_uda_torch.models.common import Conv2d, SameConv2d, same_padding
from centernet_uda_torch.ops import depthwise
from perfbench import harness
from test_torch_gpu import b3_depthwise_shapes, mnv2_depthwise_shapes

torch.set_num_threads(2)


def float64_grads(x, weight, g, stride, padding):
    """(dx, d(weight)) of ``F.conv2d`` by float64 autograd."""
    x = x.double().requires_grad_(True)
    weight = weight.double().requires_grad_(True)
    y = F.conv2d(x, weight, None, stride, padding, 1, x.shape[1])
    return torch.autograd.grad(y, (x, weight), g.double())


def operands(seed, n, c, h, w, k, stride, padding):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=gen)
    weight = torch.randn(c, 1, k, k, generator=gen)
    ho = (h + 2 * padding[0] - k) // stride + 1
    wo = (w + 2 * padding[1] - k) // stride + 1
    return x, weight, torch.randn(n, c, ho, wo, generator=gen)


def assert_close(got, want, name):
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got.double(), want.double(), rtol=1e-5,
                               atol=1e-5 * scale, msg=name)


def same_padded(x, k, stride):
    """``x`` after ``SameConv2d``'s uneven pad, and the conv's padding."""
    top, bottom = same_padding(x.shape[2], k, stride)
    left, right = same_padding(x.shape[3], k, stride)
    if top == bottom and left == right:
        return x, (top, left)
    return F.pad(x, (left, right, top, bottom)), (0, 0)


# b3's kernel, stride and padding cases scaled down: stride 1 with the
# symmetric (k - 1) / 2, stride 2 after SAME's pad (uneven through
# ``F.pad`` on the even map, even and in the conv on the odd one),
# MobileNetV2's stride 2 with padding 1; odd and even maps
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("h,w", [(12, 12), (11, 13)], ids=["even", "odd"])
@pytest.mark.parametrize("case", ["s1", "s2-same", "s2-pad1"])
def test_twin_matches_float64_autograd(k, h, w, case):
    gen = torch.Generator().manual_seed(k * 100 + h)
    x = torch.randn(2, 5, h, w, generator=gen)
    if case == "s1":
        stride, padding = 1, ((k - 1) // 2, (k - 1) // 2)
    elif case == "s2-same":
        stride = 2
        x, padding = same_padded(x, k, stride)
    else:
        stride, padding = 2, (1, 1)
    weight = torch.randn(5, 1, k, k, generator=gen)
    g = torch.randn(F.conv2d(x, weight, None, stride, padding, 1, 5).shape,
                    generator=gen)
    got = depthwise.backward_plain(x, g, weight, stride, padding)
    want = float64_grads(x, weight, g, stride, padding)
    for name, a, b in zip(("dx", "dweight"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert_close(a, b, name)


def test_same_pad_at_stride_two():
    """The stride-2 SAME case above: on the even map (b3's) an uneven pad
    through ``F.pad`` and padding 0; on the odd maps an even pad, which
    goes to the conv."""
    assert same_padding(12, 3, 2) == (0, 1)
    assert same_padding(12, 5, 2) == (1, 2)
    assert same_padding(11, 3, 2) == same_padding(13, 3, 2) == (1, 1)
    assert same_padding(11, 5, 2) == same_padding(13, 5, 2) == (2, 2)


class CardMap:
    """What ``takes_kernel`` reads of a map or weight on the card."""

    def __init__(self, shape, dtype=torch.float32, contiguous=True,
                 is_cuda=True, requires_grad=True):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.is_cuda, self._contiguous = is_cuda, contiguous
        self.requires_grad = requires_grad

    def dim(self):
        return len(self.shape)

    def numel(self):
        return self.shape.numel()

    def is_contiguous(self):
        return self._contiguous


X = (8, 144, 257, 257)


@pytest.mark.parametrize("x,w,stride,padding,dilation,groups,takes", [
    pytest.param(CardMap(X), CardMap((144, 1, 3, 3)), 2, 0, 1, 144, True,
                 id="b3-k3s2-same"),
    pytest.param(CardMap((8, 40, 256, 256)), CardMap((40, 1, 3, 3)), 1, 1,
                 1, 40, True, id="b3-k3s1"),
    pytest.param(CardMap((8, 2304, 16, 16)), CardMap((2304, 1, 3, 3)), 1,
                 (1, 1), (1, 1), 2304, True, id="b3-widest"),
    pytest.param(CardMap((8, 1392, 16, 16)), CardMap((1392, 1, 5, 5)), 1,
                 2, 1, 1392, True, id="b3-k5s1"),
    pytest.param(CardMap((32, 96, 256, 256)), CardMap((96, 1, 3, 3)), 2, 1,
                 1, 96, True, id="mnv2-k3s2-pad1"),
    pytest.param(CardMap((8, 3, 512, 512)), CardMap((40, 3, 3, 3)), 2, 0, 1,
                 1, False, id="b3-stem"),
    pytest.param(CardMap((16, 64, 128, 128)), CardMap((64, 64, 3, 3)), 1, 1,
                 1, 1, False, id="groups1"),
    pytest.param(CardMap((2, 16, 8, 8)), CardMap((16, 2, 3, 3)), 1, 1, 1, 8,
                 False, id="grouped-not-depthwise"),
    pytest.param(CardMap((2, 1, 8, 8)), CardMap((1, 1, 3, 3)), 1, 1, 1, 1,
                 False, id="one-channel"),
    pytest.param(CardMap((2, 16, 8, 8)), CardMap((32, 1, 3, 3)), 1, 1, 1,
                 16, False, id="multiplier-2"),
    pytest.param(CardMap((2, 16, 8, 8), dtype=torch.bfloat16),
                 CardMap((16, 1, 3, 3), dtype=torch.bfloat16), 1, 1, 1, 16,
                 False, id="bf16"),
    pytest.param(CardMap((2, 16, 8, 8), is_cuda=False),
                 CardMap((16, 1, 3, 3), is_cuda=False), 1, 1, 1, 16, False,
                 id="cpu"),
    pytest.param(CardMap((2, 16, 8, 8), contiguous=False),
                 CardMap((16, 1, 3, 3)), 1, 1, 1, 16, False, id="strided"),
    pytest.param(CardMap((2, 16, 8, 8), requires_grad=False),
                 CardMap((16, 1, 3, 3), requires_grad=False), 1, 1, 1, 16,
                 False, id="no-gradient"),
    pytest.param(CardMap((2, 16, 8, 8), requires_grad=False),
                 CardMap((16, 1, 3, 3)), 1, 1, 1, 16, True,
                 id="weight-gradient-only"),
    pytest.param(CardMap((2, 16, 8, 8)), CardMap((16, 1, 7, 7)), 1, 3, 1,
                 16, False, id="k7"),
    pytest.param(CardMap((2, 16, 8, 8)), CardMap((16, 1, 3, 3)), 3, 1, 1,
                 16, False, id="stride3"),
    pytest.param(CardMap((2, 16, 8, 8)), CardMap((16, 1, 3, 3)), (1, 2), 1,
                 1, 16, False, id="stride-1x2"),
    pytest.param(CardMap((2, 16, 8, 8)), CardMap((16, 1, 3, 3)), 1, 2, 2,
                 16, False, id="dilated"),
    pytest.param(CardMap((2, 16, 8, 8)), CardMap((16, 1, 3, 3)), 1, "same",
                 1, 16, False, id="string-padding"),
    pytest.param(CardMap((2, 16, 8, 8)), CardMap((16, 1, 3, 3)), 1, 3, 1,
                 16, False, id="padding-over-kernel"),
    pytest.param(CardMap((2, 16, 2, 8)), CardMap((16, 1, 5, 5)), 1, 0, 1,
                 16, False, id="map-under-kernel"),
    pytest.param(CardMap((2, 16, 8, 20000)), CardMap((16, 1, 3, 3)), 1, 1,
                 1, 16, False, id="row-over-shared-memory"),
])
def test_takes_kernel(x, w, stride, padding, dilation, groups, takes):
    assert depthwise.takes_kernel(x, w, stride, padding, dilation,
                                  groups) is takes


def test_takes_kernel_needs_grad_mode():
    x, w = CardMap((2, 16, 8, 8)), CardMap((16, 1, 3, 3))
    with torch.no_grad():
        assert not depthwise.takes_kernel(x, w, 1, 1, 1, 16)
    assert depthwise.takes_kernel(x, w, 1, 1, 1, 16)


@pytest.fixture
def cpu_as_card(monkeypatch):
    """CPU tensors pass the rule's device check (the Function then runs
    its twin); every decision of the rule and every call of
    ``depthwise_conv2d`` is recorded."""
    decisions, calls = [], []
    rule, route = depthwise.takes_kernel, depthwise.depthwise_conv2d

    def recorded_rule(x, weight, stride, padding, dilation, groups):
        took = rule(x, weight, stride, padding, dilation, groups)
        decisions.append((tuple(x.shape), tuple(weight.shape), groups, took))
        return took

    def recorded_route(x, weight, stride, padding):
        calls.append((tuple(weight.shape), stride, padding, tuple(x.shape)))
        return route(x, weight, stride, padding)

    monkeypatch.setattr(depthwise, "_on_card", lambda x: True)
    monkeypatch.setattr(depthwise, "takes_kernel", recorded_rule)
    monkeypatch.setattr(depthwise, "depthwise_conv2d", recorded_route)
    return decisions, calls


def shape_counts(calls):
    """{(c, h, w, k, stride, (ph, pw)): calls} of recorded routes."""
    out = {}
    for w, stride, padding, x in calls:
        key = (*x[1:], w[-1], stride[0], tuple(padding))
        out[key] = out.get(key, 0) + 1
    return out


def depthwise_modules(net):
    return [m for m in net.modules()
            if isinstance(m, torch.nn.Conv2d) and m.groups > 1]


def test_b3_depthwise_convs_take_the_route_and_give_atens_gradients(
        cpu_as_card, monkeypatch):
    """EfficientNet-b3 with skips at 64 px, train mode: its 26 depthwise
    convs (3x3 and 5x5, stride 1 through ``Conv2d``, stride 2 through
    ``SameConv2d``) take the route, at the shapes the card tests derive
    for them, and the stem keeps ``F.conv2d``; the
    heads' output is the same bits as without the route, and every
    parameter's gradient within 1e-4 of its own scale and 1e-6 of the
    net's largest gradient (the ``_bn2`` biases' gradients are zero but
    for float32 rounding, since a train-mode BatchNorm follows them, and
    read ~1e-8 either way)."""
    decisions, calls = cpu_as_card
    gen = torch.Generator().manual_seed(7)
    heads = {"hm": 3, "wh": 3, "reg": 2}
    net = efficientnet.CenterEfficientNet("b3", heads, use_skip=True,
                                          generator=gen).train()
    convs = depthwise_modules(net)
    assert len(convs) == 26
    assert sum(isinstance(m, SameConv2d) for m in convs) == 4
    x = torch.randn(2, 3, 64, 64, generator=gen)
    got = net(x)
    assert len(calls) == 26
    assert sorted({(w[-1], s) for w, s, _, _ in calls}, key=str) == sorted(
        {(3, (1, 1)), (5, (1, 1)), (3, (2, 2)), (5, (2, 2))}, key=str)
    assert shape_counts(calls) == b3_depthwise_shapes(64)
    stem = [d for d in decisions if d[1][1] == 3]
    assert stem and not any(d[3] for d in stem)
    assert sum(d[3] for d in decisions) == 26
    loss = sum((v.double() ** 2).mean() for v in got.values())
    grads = torch.autograd.grad(loss, list(net.parameters()))
    monkeypatch.setattr(depthwise, "_on_card", lambda x: False)
    want = net(x)
    assert len(calls) == 26
    for k in heads:
        assert torch.equal(got[k], want[k]), k
    loss = sum((v.double() ** 2).mean() for v in want.values())
    refs = torch.autograd.grad(loss, list(net.parameters()))
    largest = max(float(b.abs().max()) for b in refs)
    for (name, _), a, b in zip(net.named_parameters(), grads, refs):
        torch.testing.assert_close(
            a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()) + 1e-6 * largest,
            msg=name)


def test_mobilenetv2_depthwise_convs_take_the_route(cpu_as_card):
    """MobileNetV2's 17 depthwise 3x3 convs (stride 1 and 2, padding 1)
    take the route, at the shapes the card tests derive for them."""
    _, calls = cpu_as_card
    net = mobilenetv2.CenterMobileNetV2({"hm": 2, "wh": 2, "reg": 2},
                                        generator=torch.Generator()
                                        .manual_seed(3)).train()
    assert len(depthwise_modules(net)) == 17
    net(torch.randn(1, 3, 64, 64))
    assert len(calls) == 17
    assert {(w[-1], s, p) for w, s, p, _ in calls} == {
        (3, (1, 1), (1, 1)), (3, (2, 2), (1, 1))}
    assert shape_counts(calls) == mnv2_depthwise_shapes(64)


def test_dla34_convs_keep_their_route(cpu_as_card):
    """Every conv of DLA-34 (full width, 64 px, train mode with a
    gradient) is asked and refused: each has groups = 1; its grouped
    ``DepthwiseUp`` is a transposed conv, not a ``Conv2d``."""
    decisions, calls = cpu_as_card
    net = dla.DLASeg({"hm": 2, "wh": 2, "reg": 2}, dcn_impl="xla",
                     generator=torch.Generator().manual_seed(5)).train()
    assert depthwise_modules(net) == []
    net(torch.randn(1, 3, 64, 64))
    n_convs = sum(isinstance(m, Conv2d) for m in net.modules())
    assert calls == [] and len(decisions) >= n_convs > 0
    assert not any(d[3] for d in decisions)
    assert all(d[2] == 1 for d in decisions)


@pytest.mark.parametrize("mode", ["eval-no-grad", "no-grad", "bf16"])
def test_b0_depthwise_convs_keep_aten_without_a_float32_gradient(
        cpu_as_card, mode):
    """EfficientNet-b0 in eval under ``no_grad`` (the eval step), under
    ``no_grad`` in train mode, and in bfloat16 with a gradient: no conv
    takes the route."""
    _, calls = cpu_as_card
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    net = efficientnet.CenterEfficientNet(
        "b0", {"hm": 2}, generator=torch.Generator().manual_seed(2),
        dtype=dtype).train(mode != "eval-no-grad")
    x = torch.randn(1, 3, 64, 64)
    if mode == "bf16":
        net(x)
    else:
        with torch.no_grad():
            net(x)
    assert calls == []


@pytest.mark.parametrize("module", ["Conv2d", "SameConv2d"])
@pytest.mark.parametrize("need", ["both", "weight", "input"])
def test_function_matches_aten_gradients(cpu_as_card, module, need):
    """A depthwise ``Conv2d`` (5x5, stride 1) and ``SameConv2d`` (3x3,
    stride 2, uneven pad) on the Function: the output ``F.conv2d``'s bits,
    the gradients those of ATen's backward within 1e-5 of their scale;
    an input or a weight that takes no gradient gets none."""
    _, calls = cpu_as_card
    torch.manual_seed(9)
    if module == "Conv2d":
        conv = Conv2d(6, 6, 5, padding=2, groups=6, bias=False)
    else:
        conv = SameConv2d(6, 6, 3, 2, groups=6, bias=False)
    conv.weight.requires_grad_(need != "input")
    x = torch.randn(2, 6, 14, 13).requires_grad_(need != "weight")
    y = conv(x)
    assert len(calls) == 1
    g = torch.randn(y.shape)
    leaves = [t for t in (x, conv.weight) if t.requires_grad]
    got = torch.autograd.grad(y, leaves, g)
    with torch.no_grad():
        assert torch.equal(y, conv(x))
    assert len(calls) == 1
    x_ref = x.detach().requires_grad_(x.requires_grad)
    w_ref = conv.weight.detach().requires_grad_(conv.weight.requires_grad)
    if module == "SameConv2d":
        x_in, padding = same_padded(x_ref, 3, 2)
        want_y = F.conv2d(x_in, w_ref, None, 2, padding, 1, 6)
    else:
        want_y = F.conv2d(x_ref, w_ref, None, 1, 2, 1, 6)
    assert torch.equal(y, want_y)
    want = torch.autograd.grad(
        want_y, [t for t in (x_ref, w_ref) if t.requires_grad], g)
    for a, b in zip(got, want):
        assert_close(a, b, need)


def test_launch_names_are_the_benchmarks_depthwise_family():
    """Every kernel ``LAUNCHES`` counts is named by a pattern of the
    benchmark's depthwise family and by no other family's, so that
    ``depthwise_share.train`` counts the layer's whole device time."""
    kernels = harness.HERE / "kernels"
    others = [d.name for d in kernels.iterdir()
              if d.is_dir() and d.name != "depthwise"]
    assert others
    for name in depthwise.LAUNCHES:
        assert any(p in name for p in harness.kernel_family("depthwise"))
        for family in others:
            assert not any(p in name for p in harness.kernel_family(family))
