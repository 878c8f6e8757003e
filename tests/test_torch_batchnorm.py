"""The route of train-mode BatchNorm: which inputs take the hand-written
kernels of ``ops.batchnorm``, and the autograd Function on its plain twin
against torch's own batch norm.

The kernels run only on the card (``tests/test_torch_gpu.py``) and, built
for the CPU, in ``tests/test_torch_emulated_kernels.py``. Here the CPU
stands in for the card where a test says so: ``takes_kernel`` is replaced
by a version that accepts CPU maps, and the Function then runs its twin.
"""

import pytest
import torch

from centernet_uda_torch.models.common import BatchNorm2d
from centernet_uda_torch.ops import batchnorm


class CardMap:
    """What ``takes_kernel`` reads of a map on the card."""

    def __init__(self, shape=(2, 16, 8, 8), dtype=torch.float32,
                 contiguous=True, is_cuda=True):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.is_cuda, self._contiguous = is_cuda, contiguous

    def dim(self):
        return len(self.shape)

    def numel(self):
        return self.shape.numel()

    def is_contiguous(self):
        return self._contiguous


@pytest.mark.parametrize("x,takes", [
    pytest.param(CardMap(), True, id="cuda-f32"),
    pytest.param(CardMap(dtype=torch.bfloat16), False, id="cuda-bf16"),
    pytest.param(CardMap(dtype=torch.float64), False, id="cuda-f64"),
    pytest.param(CardMap(contiguous=False), False, id="cuda-strided"),
    pytest.param(CardMap(shape=(0, 16, 8, 8)), False, id="cuda-empty"),
    pytest.param(CardMap(shape=(2, 70000, 1, 1)), False, id="cuda-wide"),
    pytest.param(CardMap(is_cuda=False), False, id="cpu-f32"),
    pytest.param(torch.zeros(2, 16, 8, 8), False, id="cpu-tensor"),
])
def test_takes_kernel(x, takes):
    assert batchnorm.takes_kernel(x) is takes


@pytest.fixture
def cpu_as_card(monkeypatch):
    """CPU float32 maps take the Function (on its twin); the calls of
    ``batch_norm_train`` are recorded."""
    calls = []
    real = batchnorm.batch_norm_train

    def recorded(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(batchnorm, "takes_kernel",
                        lambda x: x.dtype == torch.float32)
    monkeypatch.setattr(batchnorm, "batch_norm_train", recorded)
    return calls


@pytest.mark.parametrize("mode,takes", [
    ("train", True), ("eval", False), ("grouped", False), ("bf16", False),
    ("f64", False)])
def test_batchnorm_route(cpu_as_card, mode, takes):
    """One statistics group in train mode takes the kernel route; eval
    mode, two groups and other dtypes keep theirs."""
    bn = BatchNorm2d(4).train(mode != "eval")
    if mode == "grouped":
        bn.groups = 2
    if mode == "f64":
        bn.double()
    dtype = {"bf16": torch.bfloat16, "f64": torch.float64}.get(
        mode, torch.float32)
    bn(torch.randn(4, 4, 3, 5).to(dtype))
    assert cpu_as_card == ([(4, 4, 3, 5)] if takes else [])


@pytest.mark.parametrize("eps,x_grad", [(1e-5, True), (1e-3, False)])
def test_function_matches_torch_batch_norm(cpu_as_card, monkeypatch, eps,
                                           x_grad):
    """The layer on the Function (its backward on the twin) against the
    same layer on torch's batch norm: the output and the running
    statistics the same bits, gradients of x, weight and bias within 1e-5
    of their scale; x without a gradient still gives the weight's and
    bias's."""
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn(3, 6, 5, 7, generator=gen) * 2 + 1).requires_grad_(
        x_grad)
    g = torch.randn(3, 6, 5, 7, generator=gen)
    weight, bias = torch.randn(2, 6, generator=gen)
    layers = [BatchNorm2d(6, eps=eps) for _ in range(2)]
    with torch.no_grad():
        for bn in layers:
            bn.weight.copy_(weight)
            bn.bias.copy_(bias)
    got = layers[0](x)
    assert cpu_as_card == [x.shape]
    monkeypatch.setattr(batchnorm, "takes_kernel", lambda x: False)
    want = layers[1](x)
    leaves = [layers[0].weight, layers[0].bias] + ([x] if x_grad else [])
    grads = torch.autograd.grad(got, leaves, g)
    refs = torch.autograd.grad(want, [layers[1].weight, layers[1].bias]
                               + ([x] if x_grad else []), g)
    assert torch.equal(got, want)
    for a, b in zip(grads, refs):
        scale = max(1.0, float(b.detach().abs().max()))
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * scale)
    for name in ("running_mean", "running_var"):
        assert torch.equal(getattr(layers[0], name), getattr(layers[1], name))
