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
    its inputs: the replay's output and gradients within the kernels'
    tolerance of an eager call on those values; the capture counts its
    launches, the replay none (it runs no Python)."""
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
    state before it (copied in place; the DCN kernels add with float
    atomics, and Adam moves an element whose gradient is below that noise
    by +-lr either way, so trajectories part whatever runs them). Per step
    the stats (largest difference) and the parameters (norm of the
    difference) within 4x the two eager trainers' spread plus 1e-6 of
    scale; each step's launches those of an eager step."""
    from pathlib import Path

    from centernet_uda_torch.bench import synthetic_batch
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

    from centernet_uda_torch.bench import synthetic_batch
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
