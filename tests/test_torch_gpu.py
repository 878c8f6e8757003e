"""Card-only tests: the Hopper DCN, BatchNorm and depthwise conv kernels
against their plain twins.

They need a CUDA card and skip without one. This file imports neither JAX
nor the JAX package, so on a machine without JAX it runs with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.

Tolerance: atol 5e-2 * max(1, max|reference|) and rtol 5e-2, the bound of
the Pallas kernels' own tests (tests/test_dcn_pallas.py). Kernel and twin
stage the same bf16 values; they differ by f32 summation order, which can
flip a bf16 rounding of a sample or of g . W^T. Between two calls of a
kernel on the same inputs there is no tolerance: every sum has a fixed
order, so they give the same bits. BatchNorm's backward kernels compute
in float32 as their twin does, in another order: 1e-4 of the largest
value; so do the depthwise conv's, held against the float64 twin.
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


def synthetic_batch(batch_size: int, input_size: int):
    """One seeded training batch of 6 classes and 10 objects an image: a
    copy of the JAX package's ``__graft_entry__._tiny_batch`` (the same
    numbers from the same seed) in the port's layout (NCHW images and heat
    maps)."""
    num_classes, k = 6, 10
    rng = np.random.RandomState(0)
    out_size = input_size // 4
    batch = {
        "input": rng.randn(batch_size, input_size, input_size, 3)
        .astype(np.float32).transpose(0, 3, 1, 2).copy(),
        "hm": np.zeros((batch_size, num_classes, out_size, out_size),
                       np.float32),
        "wh": rng.rand(batch_size, k, 2).astype(np.float32),
        "reg": rng.rand(batch_size, k, 2).astype(np.float32),
        "ind": rng.randint(0, out_size * out_size, (batch_size, k))
        .astype(np.int64),
        "reg_mask": (rng.rand(batch_size, k) > 0.5).astype(np.uint8),
    }
    batch["hm"][:, 0, out_size // 2, out_size // 2] = 1.0
    return batch


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


# --- bitwise repeatability ----------------------------------------------------


def bits(t):
    """``t``'s bit pattern (-0.0 and 0.0 differ; a NaN equals itself)."""
    t = t.detach().contiguous()
    if not t.is_floating_point():
        return t
    return t.view({8: torch.int64, 4: torch.int32,
                   2: torch.int16}[t.element_size()])


REPEAT_CALLS = 5


def _row_call(row, dtype, shape, cuda):
    """(call, want, split) of one row at ``shape`` (B, Cin, Cout, H, W):
    ``call()`` gives the row's outputs as a tuple, ``want`` its twin's, and
    ``split`` whether the shape splits Cin on this card (the forward's
    slices, or the backward's data kernel)."""
    b, cin, cout, h, w = shape
    cp = -(-cin // 8) * 8
    if row in (4, 5):
        x, om_w, om_b, wt, bias, g = make_fused_inputs(21, *shape, cuda)
        if row == 4:
            return ((lambda: dcn_cuda.dcn_fused_forward(x, om_w, om_b, wt,
                                                        bias)),
                    dcn_cuda.dcn_v2_fused_twin(x, om_w, om_b, wt, bias),
                    False)
        per = dcn_cuda._lib("dcn_fused_bwd").dcn_fused_bwd_data_cin_per_block(
            b, h, w, cp)
        return ((lambda: dcn_cuda.dcn_fused_backward(x, om_w, om_b, wt, g)),
                dcn_cuda.dcn_fused_backward_plain(x, om_w, om_b, wt, g),
                per < cp)
    x, off, m, wt, bias = make_inputs(21, *shape, cuda)
    g = torch.randn(b, cout, h, w, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(22))
    x, wt, g = x.to(dtype), wt.to(dtype), g.to(dtype)
    if row in (1, 2, 6):
        name = {1: "dcn_fwd", 2: "dcn_wide_fwd", 6: "dcn_sel_fwd"}[row]
        fn = {1: dcn_cuda.dcn_forward, 2: dcn_cuda.dcn_wide_forward,
              6: dcn_cuda.dcn_sel_forward}[row]
        per = getattr(dcn_cuda._lib(name), f"{name}_cin_per_block")(
            b, h, w, cp, cout)
        return ((lambda: (fn(x, off, m, wt, bias),)),
                (dcn_v2_twin(x, off, m, wt, bias, clamp_dx=row == 2),),
                per < cp)
    name = {3: "dcn_bwd", 7: "dcn_sel_bwd"}[row]
    fn = {3: dcn_cuda.dcn_backward, 7: dcn_cuda.dcn_sel_backward}[row]
    per = getattr(dcn_cuda._lib(name), f"{name}_data_cin_per_block")(
        b, h, w, cp)
    return ((lambda: fn(x, off, m, wt, g)),
            dcn_cuda.dcn_backward_plain(x, off, m, wt, g), per < cp)


# each row at its DLA-34 or MobileNetV2 path shape and at one that splits
# Cin on an H100 (132 SMs): the f32 and fused rows at DLA-34's 64 -> 64
# @128 and 512 -> 256 @16 (batch 16, 512 px); the wide forward at its 1088
# px layer (batch 4) and a short map; the select rows at MobileNetV2's
# 1280 -> 256 @16 (batch 32) and a 300 px wide map. The fused forward
# never splits Cin: its second shape narrows the channel group.
REPEAT_ROWS = [
    pytest.param(row, dtype, shape, split,
                 id=f"row{row}-{str(dtype)[6:]}-{'x'.join(map(str, shape))}")
    for row, dtypes, shapes in (
        (1, [torch.float32], [((16, 64, 64, 128, 128), False),
                              ((16, 512, 256, 16, 16), True)]),
        (2, [torch.float32, torch.bfloat16],
         [((4, 64, 64, 272, 272), False), ((1, 512, 64, 16, 264), True)]),
        (3, [torch.float32], [((16, 64, 64, 128, 128), False),
                              ((16, 512, 256, 16, 16), True)]),
        (4, [torch.bfloat16], [((16, 64, 64, 128, 128), False),
                               ((16, 512, 256, 16, 16), False)]),
        (5, [torch.bfloat16], [((16, 64, 64, 128, 128), False),
                               ((16, 512, 256, 16, 16), True)]),
        (6, [torch.float32, torch.bfloat16],
         [((32, 1280, 256, 16, 16), True), ((2, 16, 24, 8, 300), False)]),
        (7, [torch.float32, torch.bfloat16],
         [((32, 1280, 256, 16, 16), True), ((2, 16, 24, 8, 300), False)]),
    )
    for dtype in dtypes for shape, split in shapes]


@pytest.mark.parametrize("row,dtype,shape,split", REPEAT_ROWS)
def test_rows_repeat_bitwise(cuda, row, dtype, shape, split):
    """Each of the seven rows, called REPEAT_CALLS times on the same
    inputs: every output bit for bit the first call's, split or not, and
    within tolerance of its twin."""
    call, want, is_split = _row_call(row, dtype, shape, cuda)
    assert is_split == split
    first = call()
    for _ in range(REPEAT_CALLS - 1):
        again = call()
        for i, (a, b) in enumerate(zip(first, again)):
            assert torch.equal(bits(a), bits(b)), (row, i)
    for i, (a, b) in enumerate(zip(first, want)):
        assert_close(a.float(), b.float(), f"row {row} output {i}")


# --- the forward kernels as custom ops, and an exported model ------------------


def op_inputs(cuda):
    """(op, args) of each of the four forward ops at a small shape."""
    x, off, m, wt, bias = make_inputs(8, 2, 16, 24, 12, 10, cuda)
    om_w, om_b = (torch.randn(27, 16, 3, 3, device=cuda) * 0.05,
                  torch.randn(27, device=cuda))
    ops = torch.ops.centernet_uda
    return [(ops.dcn_fwd, (x, off, m, wt, bias, 14.0)),
            (ops.dcn_sel_fwd, (x.bfloat16(), off, m, wt.bfloat16(), bias,
                               14.0)),
            (ops.dcn_wide_fwd, (x, off, m, wt, bias, 14.0)),
            (ops.dcn_fused_fwd, (x.bfloat16(), om_w, om_b, wt, bias, 14.0))]


def test_custom_ops_fake_shapes_match_the_kernels(cuda):
    """Each op's fake implementation gives its kernel's shapes, dtypes and
    strides (``torch.library.opcheck`` runs the kernel beside it)."""
    for op, args in op_inputs(cuda):
        torch.library.opcheck(op, args, test_utils=(
            "test_schema", "test_faketensor"))
        out = op(*args)
        outs = out if isinstance(out, tuple) else (out,)
        assert outs[0].shape == (2, 24, 12, 10) and outs[0].is_contiguous()
        assert outs[0].dtype == args[0].dtype
    # the fused op's second output is the f32 max |dy| scalar
    assert out[1].shape == () and out[1].dtype == torch.float32


def test_exported_model_launches_the_kernels(cuda, tmp_path):
    """A narrow DLA on the card, exported with decode and reloaded: each
    call of the artifact launches the forward kernels of its 16 DCN layers
    (15 at W >= 8, one select at the 4 x 4 map) and gives the eager
    module's detections."""
    from centernet_uda_torch import models
    from centernet_uda_torch.export import (
        ServingModule,
        export_program,
        export_pt2,
        load_artifact,
    )

    backend = models.build("dla", num_classes=3, levels=(1,) * 6,
                           channels=(4, 8, 8, 16, 16, 32), head_conv=8,
                           seed=3, device="cuda")
    serving = ServingModule(backend, max_detections=10)
    path = export_pt2(export_program(serving, (1, 3, 128, 128)),
                      tmp_path / "dla")
    program = load_artifact(path).module()
    x = torch.randn(1, 3, 128, 128, device=cuda)
    with torch.no_grad():
        want = serving(x)
    dcn_cuda.reset_launches()
    got = program(x)
    torch.cuda.synchronize()
    assert dcn_cuda.LAUNCHES == only(dcn_fwd=15, dcn_sel_fwd=1)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# --- compiled steps (utils/graphs.py) ------------------------------------------


def _route_inputs(route, cuda):
    """Leaves (requiring grad) and the autograd route of one DCN kernel."""
    if route == "fused":
        x, om_w, om_b, wt, bias, _ = make_fused_inputs(8, 2, 40, 72, 13, 21,
                                                       cuda)
        return [x, om_w, om_b, wt, bias], (
            lambda *t: dcn_cuda.dcn_v2_fused_kernel(*t)[0])
    x, off, m, wt, bias = make_inputs(8, 2, 40, 72, 13, 21, cuda)
    if route == "select":
        x, wt = x.bfloat16(), wt.bfloat16()
    kernel = {"f32": dcn_cuda.dcn_v2_kernel,
              "select": dcn_cuda.dcn_v2_select_kernel,
              "wide": dcn_cuda.dcn_v2_wide_kernel}[route]
    return [x, off, m, wt, bias], kernel


@pytest.mark.parametrize("route", ["f32", "fused", "select", "wide"])
def test_kernels_capture_in_the_global_mode(cuda, route):
    """Each kernel route, forward and backward, captured into a CUDA graph
    in the global capture mode, which refuses any host call that is not
    legal under capture (the launchers' attribute queries and
    ``cudaFuncSetAttribute`` are legal), then replayed on new values of
    its inputs: the replay's output and gradients equal to an eager call
    on those values, bit for bit (the wide route's gradients, autograd
    through the exact op, within the kernels' tolerance); the capture
    counts its launches, the replay none (it runs no Python)."""
    leaves, kernel = _route_inputs(route, cuda)
    leaves = [t.detach().requires_grad_(True) for t in leaves]

    def fn():
        out = kernel(*leaves)
        return (out,) + torch.autograd.grad(out.float().square().sum(),
                                            leaves)

    fn()  # eager: loads the kernels
    graph = torch.cuda.CUDAGraph()
    dcn_cuda.reset_launches()
    with torch.cuda.graph(graph, capture_error_mode="global"):
        static = fn()
    captured = dict(dcn_cuda.LAUNCHES)
    assert sum(captured.values()) in (1, 2)
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for t in leaves[:1] + leaves[3:]:
            t.mul_((1 + 0.1 * torch.randn(t.shape, generator=gen)).to(
                t.device, t.dtype))
    graph.replay()
    torch.cuda.synchronize()
    assert dict(dcn_cuda.LAUNCHES) == captured
    want = fn()
    for name, got, ref in zip(("out", "dx", "d1", "d2", "dw", "dbias"),
                              static, want):
        assert_close(got.detach().float(), ref.detach().float(),
                     f"{route} {name}")
        # the wide route has no backward kernel: its gradients are
        # autograd through the exact op, whose gathers' gradients add with
        # atomics on the card, so they do not repeat bit for bit (ROADMAP
        # Queue C, C7, with its spread from tools/dcn_offset_spread.py)
        if route != "wide" or name == "out":
            assert torch.equal(bits(got), bits(ref)), f"{route} {name}"


def test_capturable_adam_replays_match_plain_adam(cuda):
    """The port's Adam on the card is capturable: one step captured and
    replayed for steps 2 and 3 gives plain (host-count) Adam's parameters,
    each replay with its own step's bias correction."""
    from centernet_uda_torch.utils.optim import make_optimizer

    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn(4096, generator=gen)
    grads = [torch.randn(4096, generator=gen).to(cuda) for _ in range(3)]
    ref = p0.to(cuda).requires_grad_(True)
    plain = torch.optim.Adam([ref], lr=1e-2, weight_decay=1e-4)
    p = p0.to(cuda).requires_grad_(True)
    opt = make_optimizer("Adam", {"lr": 1e-2, "weight_decay": 1e-4}, [p])
    assert opt.defaults["capturable"] and not plain.defaults["capturable"]
    ref.grad, p.grad = grads[0].clone(), grads[0].clone()
    plain.step()
    opt.step()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        opt.step()
    for g in grads[1:]:
        p.grad.copy_(g)
        graph.replay()
        ref.grad = g.clone()
        plain.step()
        torch.testing.assert_close(p, ref, rtol=1e-5, atol=1e-6)
    assert float(opt.state[p]["step"]) == 3.0


def _train_state(trainer):
    out = list(trainer.backend.module.parameters()) + list(
        trainer.backend.module.buffers())
    for st in trainer.optimizer.state.values():
        out += [v for v in st.values() if isinstance(v, torch.Tensor)]
    return out


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_graphed_dla34_steps_match_eager(cuda, precision):
    """DLA-34 at full width, 128 px, batch 2: three train steps of the
    graphed trainer (eager, capture and replay, replay) against two eager
    trainers from the same seed, each step from the first eager trainer's
    state before it (copied in place, so that a step that parted could not
    carry its difference into the next). Per step the stats (largest
    difference) and the parameters (norm of the difference) within 4x the
    two eager trainers' spread plus 1e-6 of scale, and, since the DCN
    kernels repeat bit for bit, equal to the first eager trainer's bit for
    bit; each step's launches those of an eager step."""
    from pathlib import Path

    from centernet_uda_torch.config import compose
    from centernet_uda_torch.train import build_trainer

    root = Path(__file__).resolve().parents[1]
    cfg = compose(["experiment=baseline", f"precision={precision}",
                   "batch_size=2", "model.backend.params.num_classes=6",
                   "datasets.training.params.input_size=[128,128]"],
                  config_dir=str(root / "configs"))
    data = synthetic_batch(2, 128)
    trainers = [build_trainer(cfg, device="cuda", graphs=g)
                for g in (False, False, True)]
    for t in trainers:
        t.init_done()
    stats = [[] for _ in trainers]
    params = [[] for _ in trainers]
    launches = [[] for _ in trainers]
    for _ in range(3):
        state = [v.detach().clone() for v in _train_state(trainers[0])]
        for i, t in enumerate(trainers):
            with torch.no_grad():
                for v, want in zip(_train_state(t), state):
                    v.copy_(want)
            dcn_cuda.reset_launches()
            out = t.step(data)["stats"]
            torch.cuda.synchronize()
            launches[i].append(dict(dcn_cuda.LAUNCHES))
            stats[i].append(torch.stack([out[k] for k in sorted(out)]))
            params[i].append(torch.cat([p.detach().flatten() for p in
                                        t.backend.module.parameters()]))
    assert trainers[2].step_graphs.calls == {"eager": 1, "captures": 1,
                                             "replays": 2}
    assert launches[0][0] == launches[0][1] == launches[0][2]
    assert launches[2] == launches[0] and sum(launches[0][0].values())
    for got, norm in ((stats, lambda t: t.abs().max()),
                      (params, lambda t: t.norm())):
        spread = max(float(norm(b - a)) for a, b in zip(got[0], got[1]))
        diff = max(float(norm(g - a)) for a, g in zip(got[0], got[2]))
        scale = max(float(norm(a)) for a in got[0])
        assert diff <= 4 * spread + 1e-6 * scale, (diff, spread)
        for i in (1, 2):
            for step, (a, b) in enumerate(zip(got[0], got[i])):
                assert torch.equal(bits(a), bits(b)), (i, step)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_two_dla34_trainers_stay_bitwise_equal(cuda, precision):
    """Two eager DLA-34 trainers at full width (128 px, batch 2) from one
    seed, each trained on its own for three steps on one batch, no state
    copied between them: every step's stats and, after the last step, the
    whole train state (parameters, buffers and Adam's moments) bit for
    bit."""
    from pathlib import Path

    from centernet_uda_torch.config import compose
    from centernet_uda_torch.train import build_trainer

    root = Path(__file__).resolve().parents[1]
    cfg = compose(["experiment=baseline", f"precision={precision}",
                   "batch_size=2", "model.backend.params.num_classes=6",
                   "datasets.training.params.input_size=[128,128]"],
                  config_dir=str(root / "configs"))
    data = synthetic_batch(2, 128)
    trainers = [build_trainer(cfg, device="cuda", graphs=False)
                for _ in range(2)]
    stats = [[], []]
    for i, t in enumerate(trainers):
        t.init_done()
        for _ in range(3):
            out = t.step(data)["stats"]
            stats[i].append(torch.stack([out[k] for k in sorted(out)]))
    torch.cuda.synchronize()
    for step, (a, b) in enumerate(zip(*stats)):
        assert torch.equal(bits(a), bits(b)), step
    a, b = (_train_state(t) for t in trainers)
    assert len(a) == len(b)
    for i, (u, v) in enumerate(zip(a, b)):
        assert torch.equal(bits(u), bits(v)), i


_FRESH_PROCESS_RUN = """
import hashlib, sys
import torch
sys.path.insert(0, "tests")
from test_torch_gpu import synthetic_batch
from centernet_uda_torch.config import compose
from centernet_uda_torch.train import build_trainer

cfg = compose(["experiment=baseline", "precision=" + sys.argv[1],
               "model.backend.params.num_classes=6"], config_dir="configs")
t = build_trainer(cfg, device="cuda")
t.init_done()
data = synthetic_batch(16, 512)
for _ in range(3):
    t.step(data)
torch.cuda.synchronize()
state = list(t.backend.module.parameters()) + list(t.backend.module.buffers())
for st in t.optimizer.state.values():
    state += [v for v in st.values() if isinstance(v, torch.Tensor)]
h = hashlib.sha256()
for v in state:
    h.update(v.detach().contiguous().view(-1).view(torch.uint8).cpu()
             .numpy())
calls = t.step_graphs.calls if t.step_graphs is not None else None
print(len(state), h.hexdigest(), calls)
"""


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_two_processes_train_dla34_to_the_same_bits(cuda, precision):
    """Two fresh processes, each building DLA-34 (``experiment=baseline``,
    full width, 512 px, batch 16, graphed steps) from the config's seed and
    training it three steps on one seeded batch: the same hash of the whole
    train state (parameters, buffers and Adam's moments). A process picks
    its cuDNN algorithms and kernel splits anew, so this is what a user
    comparing two runs sees."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    runs = [subprocess.run([sys.executable, "-c", _FRESH_PROCESS_RUN,
                            precision], cwd=root, capture_output=True,
                           text=True, timeout=600) for _ in range(2)]
    for r in runs:
        assert r.returncode == 0, r.stderr[-2000:]
    lines = [r.stdout.strip().splitlines()[-1] for r in runs]
    assert "replays" in lines[0], lines[0]
    assert lines[0] == lines[1], lines


def test_registered_generator_replays_draw_the_eager_draws(cuda):
    """A step that draws from a CUDA generator of its own, the generator
    named to ``StepGraphs`` and reseeded before every call: each call,
    eager, captured and replayed or replayed, gives the ``torch.rand``
    draws of an eager call after the same ``manual_seed``, bit for bit."""
    from centernet_uda_torch.utils.graphs import StepGraphs

    gen = torch.Generator(cuda)

    def fn(inputs):
        return {"a": inputs["x"] + torch.rand(1000, generator=gen,
                                              device=cuda),
                "b": torch.rand((16, 1, 1, 1), generator=gen, device=cuda)}

    graphs = StepGraphs(cuda)
    x = torch.zeros(1000)
    for step in range(4):
        gen.manual_seed(7919 + step)
        got = graphs("step", fn, {"x": x}, (gen,))
        gen.manual_seed(7919 + step)
        want = fn({"x": x.to(cuda)})
        assert torch.equal(got["a"], want["a"]), step
        assert torch.equal(got["b"], want["b"]), step
    assert graphs.calls == {"eager": 1, "captures": 1, "replays": 3}


def test_one_rank_nccl_train_step_captures_and_replays(cuda):
    """DLA-34 at full width, 128 px, batch 2, as the trainer of a one-rank
    NCCL group: the train step is graphed (its loss normalizers' and
    gradients' all-reduces captured), three steps run eagerly, captured
    and replayed, then replayed, each launching the DCN kernels of the
    eager step (at 128 px the smallest maps take the select route), with
    finite losses that move."""
    from pathlib import Path

    from centernet_uda_torch.config import compose
    from centernet_uda_torch.parallel import ddp
    from centernet_uda_torch.train import build_trainer

    root = Path(__file__).resolve().parents[1]
    cfg = compose(["experiment=baseline", "batch_size=2",
                   "model.backend.params.num_classes=6"],
                  config_dir=str(root / "configs"))
    ddp.init(ddp.Ranks(0, 1, 0, 1, port=ddp.free_port()),
             torch.device("cuda", 0))
    try:
        trainer = build_trainer(cfg, device="cuda")
        trainer.init_done()
        assert ddp.is_distributed() and trainer.compiled("train")
        data = synthetic_batch(2, 128)
        losses, launches = [], []
        for _ in range(3):
            dcn_cuda.reset_launches()
            stats = trainer.step(data)["stats"]
            torch.cuda.synchronize()
            launches.append(dict(dcn_cuda.LAUNCHES))
            losses.append(float(stats["total_loss"]))
        assert trainer.step_graphs.calls == {"eager": 1, "captures": 1,
                                             "replays": 2}
        assert launches[0] == launches[1] == launches[2]
        assert launches[0]["dcn_fwd"] + launches[0]["dcn_sel_fwd"] == 16
    finally:
        ddp.shutdown()
    assert all(np.isfinite(losses)) and len(set(losses)) == 3


def test_a_graph_the_collector_frees_does_not_break_a_capture(cuda):
    """A graphed step dropped in a reference cycle (as a discarded
    trainer's graphs are, until the cyclic collector runs), then another
    step captured whose function runs the collector (as any allocation in
    it may): the dead graph is freed before the capture, not inside it
    (where freeing it invalidates the capture), and the new step captures
    and replays the eager step's result."""
    import gc

    from centernet_uda_torch.utils.graphs import StepGraphs

    def fn(inputs):
        return {"y": inputs["x"] @ inputs["x"]}

    def collecting(inputs):
        gc.collect()
        return fn(inputs)

    x = torch.randn(64, 64)
    was = gc.isenabled()
    gc.disable()  # the cycle stays until something collects it
    try:
        old = StepGraphs(cuda)
        for _ in range(2):
            old("step", fn, {"x": x})
        assert len(old) == 1
        cycle = {"graphs": old}
        cycle["self"] = cycle
        del old, cycle
        graphs = StepGraphs(cuda)
        got = [graphs("step", collecting, {"x": x})["y"] for _ in range(3)]
        torch.cuda.synchronize()
    finally:
        if was:
            gc.enable()
    assert graphs.calls == {"eager": 1, "captures": 1, "replays": 2}
    for y in got[1:]:
        torch.testing.assert_close(y, got[0], rtol=1e-5, atol=1e-5)


def test_a_failed_capture_raises_and_does_not_fall_back(cuda):
    """A step that reads a value on the host (``.item()``) cannot be
    captured: its capture raises, and so does the next call; no call runs
    the step eagerly in its place. (Last in the file: the failed capture
    leaves its graph pool unusable.)"""
    from centernet_uda_torch.utils.graphs import StepGraphs

    def fn(inputs):
        return {"y": inputs["x"] + float(inputs["x"].sum().item())}

    graphs = StepGraphs(cuda)
    x = torch.ones(4)
    assert torch.equal(graphs("step", fn, {"x": x})["y"].cpu(), x + 4)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            graphs("step", fn, {"x": x})
    assert graphs.calls == {"eager": 1, "captures": 0, "replays": 0}
    assert len(graphs) == 0
    assert float((torch.ones(3, device=cuda) * 2).sum()) == 6.0


# --- train-mode BatchNorm (ops/batchnorm.py, csrc/bn_train.cu) -----------------


def bn_operands(seed, shape, device):
    """x with channel means away from 0, a weight, a bias and an output
    gradient, on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    n, c, h, w = shape
    x = torch.randn(shape, generator=gen) * 2.0 + torch.randn(
        1, c, 1, 1, generator=gen) * 3.0
    weight, bias = torch.randn(2, c, generator=gen)
    dy = torch.randn(shape, generator=gen)
    return tuple(t.to(device) for t in (x, weight, bias, dy))


# one shape of each class of DLA-34's and EfficientNet-b3's layers at batch
# 2: 16 channels at 512 px, 64 at 128 px, 512 at 16 px, b3's 1392 at 16 px;
# and a map whose H * W is odd (one float a vector)
BN_CARD_SHAPES = [(2, 16, 512, 512), (2, 64, 128, 128), (2, 512, 16, 16),
                  (2, 1392, 16, 16), (3, 24, 15, 17)]


@pytest.mark.parametrize("shape", BN_CARD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_batchnorm_kernels_match_twin_and_repeat(cuda, shape):
    """The forward is ``F.batch_norm``'s bits; dx, d(weight) and d(bias)
    of the backward kernels within 1e-4 of the twin's float32 (relative,
    and absolute of the largest value), and two calls the same bits; one
    launch of each kernel a call."""
    import torch.nn.functional as F

    from centernet_uda_torch.ops import batchnorm

    x, weight, bias, dy = bn_operands(5, shape, cuda)
    eps = 1e-3
    y, mean, invstd = batchnorm.batch_norm_forward(x, weight, bias, eps)
    assert torch.equal(bits(y), bits(F.batch_norm(x, None, None, weight,
                                                  bias, True, 0.0, eps)))
    batchnorm.reset_launches()
    runs = [batchnorm.batch_norm_backward(x, dy, mean, invstd, weight)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert batchnorm.LAUNCHES == dict.fromkeys(batchnorm.LAUNCHES, 2)
    want = batchnorm.backward_plain(x, dy, mean, invstd, weight)
    for name, a, b, ref in zip(("dx", "dweight", "dbias"), *runs, want):
        assert torch.equal(bits(a), bits(b)), name
        scale = max(1.0, float(ref.abs().max()))
        err = float((a - ref).abs().max())
        torch.testing.assert_close(a, ref, rtol=1e-4, atol=1e-4 * scale,
                                   msg=f"{name}: max|err| {err}")


def test_batchnorm_layer_captures_and_replays(cuda):
    """A train-mode ``BatchNorm2d`` forward and backward under
    ``StepGraphs``: eager, captured and replayed, replayed, on new inputs
    each call; every call's output and gradients the bits of an eager call
    on the same layer state, the running statistics too, and the replays
    count the kernels' launches."""
    from centernet_uda_torch.models.common import BatchNorm2d
    from centernet_uda_torch.ops import batchnorm
    from centernet_uda_torch.utils.graphs import StepGraphs

    layers = [BatchNorm2d(32).to(cuda) for _ in range(2)]

    def fn(bn):
        def step(inputs):
            x = inputs["x"].detach().requires_grad_(True)
            y = bn(x)
            grads = torch.autograd.grad(y, (x, bn.weight, bn.bias),
                                        inputs["g"])
            return (y.detach(),) + grads
        return step

    graphs = StepGraphs(cuda)
    gen = torch.Generator().manual_seed(11)
    for call in range(3):
        inputs = {"x": torch.randn(4, 32, 24, 24, generator=gen) + call,
                  "g": torch.randn(4, 32, 24, 24, generator=gen)}
        batchnorm.reset_launches()
        got = graphs("bn", fn(layers[0]), inputs)
        torch.cuda.synchronize()
        assert batchnorm.LAUNCHES == dict.fromkeys(batchnorm.LAUNCHES, 1)
        want = fn(layers[1])({k: v.to(cuda) for k, v in inputs.items()})
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(bits(a), bits(b)), (call, i)
        for name in ("running_mean", "running_var"):
            assert torch.equal(getattr(layers[0], name),
                               getattr(layers[1], name)), (call, name)
    assert graphs.calls == {"eager": 1, "captures": 1, "replays": 2}


def test_eager_dla34_step_launches_the_batchnorm_kernels(cuda):
    """One eager DLA-34 train step at float32 (full width, 128 px, batch 2)
    back-propagates its BatchNorm layers through the kernels: 53 launches
    of each (of its 55 layers, the ``project`` ones of ``base.level3`` and
    ``base.level4`` reach no loss, as in the reference DLA, so autograd
    runs no backward of theirs)."""
    from pathlib import Path

    from centernet_uda_torch.config import compose
    from centernet_uda_torch.ops import batchnorm
    from centernet_uda_torch.train import build_trainer

    root = Path(__file__).resolve().parents[1]
    cfg = compose(["experiment=baseline", "batch_size=2",
                   "model.backend.params.num_classes=6",
                   "datasets.training.params.input_size=[128,128]"],
                  config_dir=str(root / "configs"))
    trainer = build_trainer(cfg, device="cuda", graphs=False)
    trainer.init_done()
    batchnorm.reset_launches()
    trainer.step(synthetic_batch(2, 128))
    torch.cuda.synchronize()
    assert batchnorm.LAUNCHES == dict.fromkeys(batchnorm.LAUNCHES, 53)


# --- depthwise conv backward (ops/depthwise.py, csrc/depthwise_bwd.cu) -------


def b3_depthwise_shapes(size=512):
    """{(c, h, w, k, stride, (ph, pw)): layers} of EfficientNet-b3's 26
    depthwise convs at ``size`` px as the kernels see them: the stride-2
    ones on ``SameConv2d``'s padded map where its pad is uneven."""
    from centernet_uda_torch.models.common import same_padding
    from centernet_uda_torch.models.efficientnet import block_specs

    shapes, h = {}, -(-size // 2)
    for k, cin, _, expand, stride in block_specs("b3"):
        c, key = cin * expand, None
        if stride == 1:
            key = (c, h, h, k, 1, ((k - 1) // 2,) * 2)
        else:
            top, bottom = same_padding(h, k, 2)
            if top == bottom:
                key = (c, h, h, k, 2, (top, top))
            else:
                key = (c, h + top + bottom, h + top + bottom, k, 2, (0, 0))
            h = -(-h // 2)
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def mnv2_depthwise_shapes(size=512):
    """The same for MobileNetV2's 17 depthwise 3x3 convs (padding 1)."""
    from centernet_uda_torch.models.mobilenetv2 import (
        INVERTED_RESIDUAL_CFG,
    )

    shapes, h, cin = {}, size // 2, 32
    for expand, cout, n, s in INVERTED_RESIDUAL_CFG:
        for i in range(n):
            stride = s if i == 0 else 1
            key = (cin * expand, h, h, 3, stride, (1, 1))
            shapes[key] = shapes.get(key, 0) + 1
            h, cin = (h - 1) // stride + 1, cout
    return shapes


# b3 at batch 8, MobileNetV2 at batch 32 (their recipes' batches), 512 px
DW_CARD_SHAPES = ([(8,) + key for key in b3_depthwise_shapes()]
                  + [(32,) + key for key in mnv2_depthwise_shapes()])


@pytest.mark.parametrize("shape", DW_CARD_SHAPES, ids=lambda s: "x".join(
    map(str, s[:5])) + f"-s{s[5]}-p{s[6][0]}{s[6][1]}")
def test_depthwise_kernels_match_twin_and_aten_and_repeat(cuda, shape):
    """dx and d(weight) of the kernels within 1e-4 of the largest value of
    the float64 twin, as ATen's float32 backward is (both sum in float32,
    each in its own order, up to 524 k products a d(weight) value); 5
    calls the same bits; one launch of each kernel a call."""
    from centernet_uda_torch.ops import depthwise

    n, c, h, w, k, stride, pad = shape
    gen = torch.Generator().manual_seed(c + h)
    x = torch.randn(n, c, h, w, generator=gen).to(cuda)
    weight = (torch.randn(c, 1, k, k, generator=gen) / k).to(cuda)
    y = torch.nn.functional.conv2d(x, weight, None, stride, pad, 1, c)
    g = torch.randn(y.shape, generator=gen).to(cuda)
    depthwise.reset_launches()
    runs = [depthwise.depthwise_backward(x, g, weight, stride, pad)
            for _ in range(REPEAT_CALLS)]
    torch.cuda.synchronize()
    assert depthwise.LAUNCHES == dict.fromkeys(depthwise.LAUNCHES,
                                               REPEAT_CALLS)
    exact = depthwise.backward_plain(x.double(), g.double(), weight.double(),
                                     stride, pad)
    aten = torch.ops.aten.convolution_backward(
        g, x, weight, None, [stride] * 2, list(pad), [1, 1], False, [0, 0],
        c, [True, True, False])[:2]
    for i, name in enumerate(("dx", "dweight")):
        for run in runs[1:]:
            assert torch.equal(bits(runs[0][i]), bits(run[i])), name
        scale = max(1.0, float(exact[i].abs().max()))
        for who, got in (("kernel", runs[0][i]), ("aten", aten[i])):
            err = float((got.double() - exact[i]).abs().max())
            assert err <= 1e-4 * scale, f"{who} {name}: max|err| {err}"


def test_depthwise_layer_captures_and_replays(cuda):
    """A depthwise ``Conv2d`` (5x5) and a ``SameConv2d`` (3x3, stride 2)
    forward and backward under ``StepGraphs``: eager, captured and
    replayed, replayed, on new inputs each call; every call's output and
    gradients the bits of an eager call, and the replays count the
    kernels' launches."""
    from centernet_uda_torch.models.common import Conv2d, SameConv2d
    from centernet_uda_torch.ops import depthwise
    from centernet_uda_torch.utils.graphs import StepGraphs

    torch.manual_seed(13)
    convs = [Conv2d(48, 48, 5, padding=2, groups=48, bias=False).to(cuda),
             SameConv2d(48, 48, 3, 2, groups=48, bias=False).to(cuda)]

    def step(inputs):
        x = inputs["x"].detach().requires_grad_(True)
        y = convs[1](convs[0](x))
        grads = torch.autograd.grad(
            y, (x, convs[0].weight, convs[1].weight), inputs["g"])
        return (y.detach(),) + grads

    graphs = StepGraphs(cuda)
    gen = torch.Generator().manual_seed(17)
    for call in range(3):
        inputs = {"x": torch.randn(4, 48, 40, 40, generator=gen),
                  "g": torch.randn(4, 48, 20, 20, generator=gen)}
        depthwise.reset_launches()
        got = graphs("dw", step, inputs)
        torch.cuda.synchronize()
        assert depthwise.LAUNCHES == dict.fromkeys(depthwise.LAUNCHES, 2)
        want = step({k: v.to(cuda) for k, v in inputs.items()})
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(bits(a), bits(b)), (call, i)
    assert graphs.calls == {"eager": 1, "captures": 1, "replays": 2}


def test_b3_step_launches_the_depthwise_kernels(cuda):
    """One eager EfficientNet-b3 forward and backward (skips, train mode,
    float32, 128 px, batch 2) back-propagates its 26 depthwise convs
    through the kernels: 26 launches of each; the stem and every other
    conv keep ATen or cuDNN."""
    from centernet_uda_torch.models import efficientnet
    from centernet_uda_torch.ops import depthwise

    net = efficientnet.CenterEfficientNet(
        "b3", {"hm": 6, "wh": 3, "reg": 2, "kps": 10}, use_skip=True,
        generator=torch.Generator().manual_seed(3)).to(cuda).train()
    x = torch.randn(2, 3, 128, 128, device=cuda)
    depthwise.reset_launches()
    loss = sum(v.square().mean() for v in net(x).values())
    loss.backward()
    torch.cuda.synchronize()
    assert depthwise.LAUNCHES == dict.fromkeys(depthwise.LAUNCHES, 26)
