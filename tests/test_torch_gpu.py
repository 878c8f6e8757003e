"""Card-only tests: the Hopper DCN kernels against their plain twins.

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
    # the twins' f32 convolutions and products in full f32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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


def only(**counts):
    """The launch counters with ``counts`` and every other kernel at 0."""
    return {name: counts.get(name, 0) for name in dcn_cuda.SOURCES}


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


# the tensor-core forward's channel groups: Cout 264 in two groups, not a
# multiple of 16; Cin split across blocks where the grid is short (512
# channels of 4 tiles, batch 2)
FWD_SHAPES = SHAPES + [(2, 24, 264, 13, 21), (2, 512, 256, 16, 16)]


@pytest.mark.parametrize("shape", FWD_SHAPES)
def test_forward_matches_twin(cuda, shape):
    x, off, m, wt, bias = make_inputs(0, *shape, cuda)
    dcn_cuda.reset_launches()
    got = dcn_cuda.dcn_forward(x, off, m, wt, bias)
    torch.cuda.synchronize()
    assert dcn_cuda.LAUNCHES["dcn_fwd"] == 1
    assert_close(got, dcn_v2_twin(x, off, m, wt, bias), "out")
    # f32 sums, not rounded to bf16
    assert bool((got != got.bfloat16().float()).any())


# the tensor-core backward's data kernel splits Cin across blocks where the
# grid is short: 512 channels of 4 tiles, batch 2; MobileNetV2's 1280 -> 256
# at the 800 px eval shape, batch 4
BWD_SHAPES = SHAPES + [(2, 512, 256, 16, 16), (4, 1280, 256, 25, 25)]


@pytest.mark.parametrize("shape", BWD_SHAPES)
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
    assert dcn_cuda.LAUNCHES == only(dcn_fwd=1, dcn_bwd=1)
    assert_close(bias.grad, (2 * out.detach()).sum((0, 2, 3)), "dbias")


def test_rejects_other_dtypes(cuda):
    x, off, m, wt, bias = make_inputs(4, 1, 8, 8, 8, 8, cuda)
    with pytest.raises(TypeError):
        dcn_cuda.dcn_forward(x.double(), off, m, wt, bias)
    # the float32 kernels reject bf16 x: the bf16 layer must take the fused
    # wrappers, not a cast back to f32
    with pytest.raises(TypeError):
        dcn_cuda.dcn_forward(x.bfloat16(), off, m, wt, bias)
    om_w, om_b = torch.zeros(27, 8, 3, 3, device=cuda), torch.zeros(
        27, device=cuda)
    with pytest.raises(TypeError):
        dcn_cuda.dcn_fused_forward(x, om_w, om_b, wt, bias)
    with pytest.raises(TypeError):
        dcn_cuda.dcn_fused_backward(x.bfloat16(), om_w, om_b, wt,
                                    torch.zeros(1, 8, 8, 8, device=cuda))


# ---------------------------------------------------------------------------
# the fused bf16 kernels (offset conv inside), against dcn_v2_fused_twin
# ---------------------------------------------------------------------------


def make_fused_inputs(seed, b, cin, cout, h, w, device, om_std=2.0):
    """bf16 x; offset-conv weights scaled so the offsets have std about
    ``om_std``; input channel 0 zero except on the first and last rows,
    where the offset conv's centre tap lifts dy of taps 0 and 4 to +-20,
    past the clamp. x comes in steps of 1/8 and the offset conv's weights
    and bias in steps of 1/64, the bias shifted by 1/1024: the offset conv
    is then exact in f32 in any summation order, and every offset lies at
    least 1/1024 from an integer, so kernel and twin take the sampler's
    offset gradient on the same side of every integer crossing."""
    rng = np.random.RandomState(seed)
    x = (np.round(rng.randn(b, cin, h, w) * 8) / 8).astype(np.float32)
    om_w = (np.round(rng.randn(27, cin, 3, 3) * om_std * 64 / np.sqrt(9 * cin))
            / 64).astype(np.float32)
    om_b = (np.round(rng.randn(27) * 32) / 64 + 1 / 1024).astype(np.float32)
    x[:, 0] = 0.0
    x[:, 0, 0, :] = 4.0
    x[:, 0, -1, :] = -4.0
    om_w[:, 0] = 0.0
    om_w[0, 0, 1, 1] = 5.0   # tap 0's dy: +20 on row 0
    om_w[8, 0, 1, 1] = 5.0   # tap 4's dy: -20 on the last row
    wt = (rng.randn(cout, cin, 3, 3) / np.sqrt(9 * cin)).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    g = rng.randn(b, cout, h, w).astype(np.float32)
    t = [torch.tensor(v, device=device) for v in (x, om_w, om_b, wt, bias, g)]
    t[0], t[5] = t[0].bfloat16(), t[5].bfloat16()
    return t


FUSED_SHAPES = [
    # (b, cin, cout, h, w): tiny, ragged tiles, two DLA-34 neck shapes
    (2, 8, 8, 16, 16),
    (2, 40, 72, 13, 21),
    (4, 64, 64, 32, 32),
    (2, 256, 128, 25, 25),
    # the 8 x 8 pixel tile's edges: W = 8 and W = 256; Cout 264 (two
    # channel groups) at Cin 40; one image under one tile; MobileNetV2's
    # 256 -> 256 @64
    (2, 16, 32, 12, 8),
    (1, 32, 64, 9, 256),
    (2, 40, 264, 11, 13),
    (1, 24, 48, 5, 8),
    (4, 256, 256, 64, 64),
]


@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_forward_matches_twin(cuda, shape):
    x, om_w, om_b, wt, bias, _ = make_fused_inputs(0, *shape, cuda)
    dcn_cuda.reset_launches()
    out, stat = dcn_cuda.dcn_fused_forward(x, om_w, om_b, wt, bias)
    torch.cuda.synchronize()
    assert dcn_cuda.LAUNCHES["dcn_fused_fwd"] == 1
    assert out.dtype == torch.bfloat16
    ref, ref_stat = dcn_cuda.dcn_v2_fused_twin(x, om_w, om_b, wt, bias)
    assert_close(out, ref, "out")
    assert float(ref_stat) > PALLAS_MAX_SHIFT
    assert float(stat) == pytest.approx(float(ref_stat), rel=1e-5)


@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_backward_matches_twin(cuda, shape):
    x, om_w, om_b, wt, bias, g = make_fused_inputs(1, *shape, cuda)
    dcn_cuda.reset_launches()
    got = dcn_cuda.dcn_fused_backward(x, om_w, om_b, wt, g)
    torch.cuda.synchronize()
    assert dcn_cuda.LAUNCHES["dcn_fused_bwd"] == 1
    assert got[0].dtype == torch.bfloat16
    want = dcn_cuda.dcn_fused_backward_plain(x, om_w, om_b, wt, g)
    for name, a, b in zip(("dx", "d om_w", "d om_b", "dw"), got, want):
        assert_close(a, b, name)


def test_fused_zero_init_first_step(cuda):
    """The zero-initialised offset conv: every sample sits on an integer
    position, where the y0+1 corner still enters d(dy), so the offset
    conv's gradients are nonzero from the first step."""
    x, om_w, om_b, wt, bias, g = make_fused_inputs(2, 2, 16, 16, 12, 12,
                                                   cuda)
    om_w.zero_()
    om_b.zero_()
    out, stat = dcn_cuda.dcn_fused_forward(x, om_w, om_b, wt, bias)
    assert float(stat) == 0.0
    assert_close(out, dcn_cuda.dcn_v2_fused_twin(x, om_w, om_b, wt,
                                                 bias)[0], "out")
    got = dcn_cuda.dcn_fused_backward(x, om_w, om_b, wt, g)
    want = dcn_cuda.dcn_fused_backward_plain(x, om_w, om_b, wt, g)
    for name, a, b in zip(("dx", "d om_w", "d om_b", "dw"), got, want):
        assert_close(a, b, name)
    assert float(got[1][0::2][:9].abs().max()) > 0.0  # the dy rows


def test_fused_uniform_offsets(cuda):
    """The offset conv's weight zeroed: every pixel has the bias's
    fractional offsets, so neighbouring pixels share bilinear corners with
    nonzero weights (the data kernel merges their dx reductions)."""
    x, om_w, om_b, wt, bias, g = make_fused_inputs(5, 2, 40, 72, 13, 21,
                                                   cuda)
    om_w.zero_()
    got = dcn_cuda.dcn_fused_backward(x, om_w, om_b, wt, g)
    want = dcn_cuda.dcn_fused_backward_plain(x, om_w, om_b, wt, g)
    for name, a, b in zip(("dx", "d om_w", "d om_b", "dw"), got, want):
        assert_close(a, b, name)


def test_fused_clamp_rows_pass_no_dy_gradient(cuda):
    """Input channel 0 is nonzero on the first and last rows only, where
    it lifts dy of taps 0 and 4 past the clamp: the centre-tap offset-conv
    weights from it to those dy channels get exactly zero gradient."""
    # 32 rows, so the clamped samples (14 rows away) still land on the map
    x, om_w, om_b, wt, bias, g = make_fused_inputs(3, 2, 16, 16, 32, 32,
                                                   cuda)
    d_om_w = dcn_cuda.dcn_fused_backward(x, om_w, om_b, wt, g)[1]
    assert float(d_om_w[0, 0, 1, 1]) == 0.0
    assert float(d_om_w[8, 0, 1, 1]) == 0.0
    assert float(d_om_w[1, 0, 1, 1].abs()) > 0.0  # tap 0's dx is live


def test_fused_autograd_function_counts_and_bias(cuda):
    x, om_w, om_b, wt, bias, g = make_fused_inputs(4, 2, 16, 24, 8, 8, cuda)
    leaves = [x.requires_grad_(True)] + [t.requires_grad_(True) for t in (
        om_w, om_b, wt, bias)]
    dcn_cuda.reset_launches()
    out, stat = dcn_cuda.dcn_v2_fused_kernel(*leaves)
    out.float().square().sum().backward()
    assert dcn_cuda.LAUNCHES == only(dcn_fused_fwd=1, dcn_fused_bwd=1)
    assert not stat.requires_grad
    assert x.grad.dtype == torch.bfloat16
    assert {t.grad.dtype for t in leaves[1:]} == {torch.float32}
    g_out = (2 * out.detach().float()).bfloat16().float()
    assert_close(bias.grad, g_out.sum((0, 2, 3)), "dbias")


# ---------------------------------------------------------------------------
# the "select" pair (x and out in f32 or bf16) and the wide forward, against
# dcn_v2_twin
# ---------------------------------------------------------------------------

SEL_SHAPES = [
    # (b, cin, cout, h, w): Cin > 512 at MobileNetV2's 16 x 16, W < 8,
    # W > 256; MobileNetV2's 800 px eval shape (Cin split across the data
    # kernel's blocks); Cin split at one tile, Cout over one 256 group;
    # W = 300 at 64 channels
    (2, 1280, 256, 16, 16),
    (2, 40, 72, 13, 5),
    (1, 16, 24, 6, 300),
    (4, 1280, 256, 25, 25),
    (1, 384, 264, 4, 8),
    (2, 64, 64, 300, 300),
]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SEL_SHAPES)
def test_select_pair_matches_twin(cuda, shape, dtype):
    x, off, m, wt, bias = make_inputs(5, *shape, cuda)
    x, wt = x.to(dtype), wt.to(dtype)
    g = torch.randn(shape[0], shape[2], shape[3], shape[4], device=cuda,
                    generator=torch.Generator(cuda).manual_seed(2)).to(dtype)
    dcn_cuda.reset_launches()
    out = dcn_cuda.dcn_sel_forward(x, off, m, wt, bias)
    got = dcn_cuda.dcn_sel_backward(x, off, m, wt, g)
    torch.cuda.synchronize()
    assert dcn_cuda.LAUNCHES == only(dcn_sel_fwd=1, dcn_sel_bwd=1)
    assert out.dtype == got[0].dtype == dtype and got[3].dtype == dtype
    assert_close(out, dcn_v2_twin(x, off, m, wt, bias), "out")
    want = dcn_cuda.dcn_backward_plain(x, off, m, wt, g)
    for name, a, b in zip(("dx", "doff", "dmask", "dw"), got, want):
        assert_close(a, b, name)
    sat = off[:, 0::2].abs() >= PALLAS_MAX_SHIFT
    assert float(got[1][:, 0::2][sat].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 16, 24, 8, 300), (1, 40, 72, 13, 21)])
def test_wide_forward_matches_clamp_dx_twin(cuda, shape, dtype):
    x, off, m, wt, bias = make_inputs(6, *shape, cuda)
    off[:, 1::2] *= 8.0  # dx past the clamp at many pixels
    x = x.to(dtype)
    dcn_cuda.reset_launches()
    out = dcn_cuda.dcn_wide_forward(x, off, m, wt, bias)
    torch.cuda.synchronize()
    assert dcn_cuda.LAUNCHES == only(dcn_wide_fwd=1)
    assert out.dtype == dtype
    assert_close(out, dcn_v2_twin(x, off, m, wt, bias, clamp_dx=True),
                 "out")


def test_select_and_wide_autograd_functions(cuda):
    """The select route differentiates through its kernel pair, with a bf16
    weight's gradient in bf16; the wide route runs its forward kernel and
    the exact op's backward (no kernel)."""
    x, off, m, wt, bias = make_inputs(7, 2, 24, 16, 6, 10, cuda)
    leaves = [x.bfloat16().requires_grad_(True), off.requires_grad_(True),
              m.requires_grad_(True), wt.bfloat16().requires_grad_(True),
              bias.requires_grad_(True)]
    dcn_cuda.reset_launches()
    out = dcn_cuda.dcn_v2_select_kernel(*leaves)
    out.float().square().sum().backward()
    assert dcn_cuda.LAUNCHES == only(dcn_sel_fwd=1, dcn_sel_bwd=1)
    assert leaves[0].grad.dtype == leaves[3].grad.dtype == torch.bfloat16
    assert bias.grad.dtype == torch.float32
    leaves = [t.detach().float().requires_grad_(True) for t in leaves]
    dcn_cuda.reset_launches()
    out = dcn_cuda.dcn_v2_wide_kernel(*leaves)
    out.square().sum().backward()
    assert dcn_cuda.LAUNCHES == only(dcn_wide_fwd=1)
    want = dcn_cuda.dcn_wide_backward(*[t.detach() for t in leaves],
                                      2 * out.detach())
    for t, w in zip(leaves, want):
        assert_close(t.grad, w, "wide grad")


# --- backbones without a DCN layer, freeze_base ---------------------------------


@pytest.mark.parametrize("name,params", [
    ("resnet", dict(num_layers=18)),
    ("efficientnet", dict(variant="b0", use_skip=True))],
    ids=["resnet18", "efficientnet-b0"])
def test_backbone_heads_on_the_card_match_the_cpu(cuda, name, params):
    """The same f32 module and input on the card (TF32 off) and on the
    CPU: heads within 1e-3 of their scale, in eval and train mode, and no
    DCN launch."""
    from centernet_uda_torch import models

    net = models.build(name, num_classes=3, seed=3, device="cpu",
                       **params).module
    card = models.build(name, num_classes=3, seed=3, device="cuda",
                        **params).module
    x = torch.tensor(np.random.RandomState(0).randn(2, 3, 128, 128).astype(
        np.float32))
    dcn_cuda.reset_launches()
    for train in (False, True):
        with torch.no_grad():
            want = net.train(train)(x)
            got = card.train(train)(x.to(cuda))
        for k, w in want.items():
            scale = float(w.abs().max())
            err = float((got[k].cpu() - w).abs().max())
            assert err <= 1e-3 * scale, (k, train, err / scale)
    assert dcn_cuda.LAUNCHES == only()


def test_freeze_base_keeps_the_trunk_on_the_card(cuda):
    """ResNet-18 with ``freeze_base`` and weight decay: after 3 steps on the
    card every trunk parameter is bitwise unchanged and every other one has
    moved."""
    from centernet_uda_torch.config import compose
    from centernet_uda_torch.ops.gaussian import encode_targets
    from centernet_uda_torch.train import build_trainer

    trainer = build_trainer(compose([
        "experiment=baseline_resnet18", "model.backend.params.num_classes=3",
        "model.backend.params.freeze_base=true", "batch_size=2",
        "optimizer.params.weight_decay=0.0001"]), device="cuda")
    trainer.init_done()
    net = trainer.backend.module
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    rng = np.random.RandomState(0)
    t = encode_targets(np.array([[4.0, 4.0, 20.0, 18.0]]), [1], 32, 32, 3, 8)
    data = {k: np.stack([v, v]) for k, v in t.items()}
    for _ in range(3):
        data["input"] = rng.randn(2, 3, 128, 128).astype(np.float32)
        trainer.step(dict(data), is_training=True)
    for k, p in net.named_parameters():
        if k.startswith("base."):
            assert torch.equal(p, before[k]), k
        else:
            assert not torch.equal(p, before[k]), k
