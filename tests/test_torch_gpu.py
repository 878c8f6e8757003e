"""Card-only tests: the Hopper DCN kernels against their plain twin.

They need a CUDA card and skip without one. This file imports neither JAX
nor the JAX package, so on a machine without JAX it runs with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.

Tolerance: atol 5e-2 * max(1, max|reference|) and rtol 5e-2, the bound of
the Pallas kernels' own tests (tests/test_dcn_pallas.py). Kernel and twin
stage the same bf16 values; they differ by f32 summation order (and the dx
and dW atomics, whose order changes from run to run), which can flip a
bf16 rounding of a sample or of g . W^T.
"""

import numpy as np
import pytest
import torch

from centernet_uda_torch.ops import dcn_cuda
from centernet_uda_torch.ops.dcn import PALLAS_MAX_SHIFT, dcn_v2_twin

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def make_inputs(seed, b, cin, cout, h, w, device, off_std=2.0):
    """Seeded operands with |dy| > 14 at a few pixels and dx far off the map
    at a few others, so the clamp and the zero reads are exercised."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, cin, h, w).astype(np.float32)
    off = (rng.randn(b, 18, h, w) * off_std).astype(np.float32)
    off[:, 0, 0, : w // 2] = 20.0
    off[:, 4, -1, w // 2:] = -17.5
    off[:, 7, h // 2, :] = -3.0 * w
    m = rng.rand(b, 9, h, w).astype(np.float32)
    wt = (rng.randn(cout, cin, 3, 3) / np.sqrt(9 * cin)).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    return [torch.tensor(v, device=device) for v in (x, off, m, wt, bias)]


def assert_close(got, want, name):
    got, want = got.double().cpu(), want.double().cpu()
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert torch.isfinite(got).all(), name
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-2 * scale,
                               rtol=5e-2, err_msg=f"{name}: max|err| {err}")


SHAPES = [
    # (b, cin, cout, h, w): tiny, ragged tiles, one path-like shape
    (2, 8, 8, 16, 16),
    (2, 40, 72, 13, 21),
    (2, 64, 64, 32, 32),
]


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_twin(cuda, shape):
    x, off, m, wt, bias = make_inputs(0, *shape, cuda)
    dcn_cuda.reset_launches()
    got = dcn_cuda.dcn_forward(x, off, m, wt, bias)
    torch.cuda.synchronize()
    assert dcn_cuda.LAUNCHES["dcn_fwd"] == 1
    assert_close(got, dcn_v2_twin(x, off, m, wt, bias), "out")


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_twin(cuda, shape):
    x, off, m, wt, bias = make_inputs(1, *shape, cuda)
    g = torch.randn(shape[0], shape[2], shape[3], shape[4], device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    dcn_cuda.reset_launches()
    got = dcn_cuda.dcn_backward(x, off, m, wt, g)
    torch.cuda.synchronize()
    assert dcn_cuda.LAUNCHES["dcn_bwd"] == 1
    want = dcn_cuda.dcn_backward_plain(x, off, m, wt, g)
    for name, a, b in zip(("dx", "doff", "dmask", "dw"), got, want):
        assert_close(a, b, name)
    # the clamp: no dy gradient where |dy| >= max_shift
    sat = off[:, 0::2].abs() >= PALLAS_MAX_SHIFT
    assert float(got[1][:, 0::2][sat].abs().max()) == 0.0


def test_zero_offsets_first_step(cuda):
    """Zero offsets (the zero-initialised offset conv): every sample sits on
    an integer position, where the y0+1 corner still enters d(dy)."""
    x, off, m, wt, bias = make_inputs(2, 2, 16, 16, 12, 12, cuda)
    off.zero_()
    g = torch.randn(2, 16, 12, 12, device=cuda)
    got = dcn_cuda.dcn_backward(x, off, m, wt, g)
    want = dcn_cuda.dcn_backward_plain(x, off, m, wt, g)
    for name, a, b in zip(("dx", "doff", "dmask", "dw"), got, want):
        assert_close(a, b, name)
    assert float(got[1].abs().max()) > 0.0


def test_autograd_function_counts_and_bias(cuda):
    x, off, m, wt, bias = make_inputs(3, 2, 16, 24, 8, 8, cuda)
    leaves = [t.requires_grad_(True) for t in (x, off, m, wt, bias)]
    dcn_cuda.reset_launches()
    out = dcn_cuda.dcn_v2_kernel(*leaves)
    out.square().sum().backward()
    assert dcn_cuda.LAUNCHES == {"dcn_fwd": 1, "dcn_bwd": 1}
    assert_close(bias.grad, (2 * out.detach()).sum((0, 2, 3)), "dbias")


def test_rejects_other_dtypes(cuda):
    x, off, m, wt, bias = make_inputs(4, 1, 8, 8, 8, 8, cuda)
    with pytest.raises(TypeError):
        dcn_cuda.dcn_forward(x.double(), off, m, wt, bias)
