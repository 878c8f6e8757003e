"""The port's fused bf16 DCN against the JAX package's (CPU).

- ``dcn_v2_fused_twin`` (the plain version of the fused Hopper kernels):
  its output, max |dy| and, by autograd, all five gradients against the
  Pallas kernels ``dcn_v2_pallas_lanes_fused`` /
  ``dcn_v2_pallas_bwd_lanes_fused`` run in interpret mode;
- the ``DCN`` module at bfloat16 on the kernel path (``impl="cuda"``, which
  on a CPU tensor is the fused twin) against the JAX ``DCN(use_pallas=True,
  dtype=bfloat16)``, whose fused op runs the same Pallas kernels
  interpreted on the CPU.

Tolerance: atol 5e-2 * max(1, max|reference|) and rtol 5e-2, the bound of
the float32 kernels' tests and of the Pallas kernels' own. Both sides stage
x, the offset-conv weights, W and the samples in bf16 and round gcol and dz
to bf16; the Pallas kernels also round their horizontal tent weights and the
select weights of the backward to bf16, which the twin keeps in f32, and
the two sum in other orders, so a bf16 rounding can flip. The offsets sit
away from integer crossings (fractional parts in [0.4, 0.6]), where a floor
would otherwise flip on f32 noise. max |dy| agrees to 1e-5 relative: both
take it over the same f32 offset conv of the same bf16 operands, over the
real rows (each shape's H is a whole number of the Pallas row blocks).

Inputs are numpy arrays from a seed; NCHW <-> NHWC at the boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_uda_tpu.ops import dcn as jax_dcn
from centernet_uda_tpu.ops.dcn_pallas import (
    dcn_v2_pallas_bwd_lanes_fused,
    dcn_v2_pallas_lanes_fused,
)
from centernet_uda_torch.ops import dcn_cuda
from centernet_uda_torch.ops.dcn import (
    DCN,
    PALLAS_MAX_SHIFT,
    dcn_v2_fused_twin,
)

torch.set_num_threads(2)

TOL = 5e-2


def nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a, np.float32), -1, 1))).to(dtype)


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(w, np.float32).transpose(3, 2, 0, 1)))


def hwio(t):
    return t.detach().float().numpy().transpose(2, 3, 1, 0)


def close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), name
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=name)


def fused_operands(seed, b, h, w, cin, cout, clamp_row=None):
    """x (NHWC, bf16 values), offset-conv kernel and bias with offsets of
    fractional part in [0.4, 0.6], W (bf16 values), bias, g (bf16 values).
    With ``clamp_row``, input channel 0 is zero except on that row, where
    the offset conv's centre tap lifts dy of tap 0 to about 15.4, past the
    clamp, on that row only."""
    rng = np.random.RandomState(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    x = bf(rng.randn(b, h, w, cin))
    om_k = (rng.randn(3, 3, cin, 27) * 1e-3).astype(np.float32)
    om_b = np.zeros(27, np.float32)
    om_b[:18] = 0.4 + rng.rand(18) * 0.2
    om_b[18:] = rng.randn(9) * 0.5
    if clamp_row is not None:
        x[..., 0] = 0.0
        x[:, clamp_row, :, 0] = 7.5
        om_k[:, :, 0, :] = 0.0
        om_k[1, 1, 0, 0] = 2.0
    wgt = bf(rng.randn(3, 3, cin, cout) * 0.1)
    bias = rng.randn(cout).astype(np.float32)
    g = bf(rng.randn(b, h, w, cout))
    return x, om_k, om_b, wgt, bias, g


FUSED_SHAPES = [
    # (b, h, w, cin, cout, clamp_row)
    (2, 16, 16, 8, 8, None),
    (4, 8, 20, 8, 8, None),    # lane-packed on the TPU (4 images per row)
    (1, 8, 140, 8, 8, None),   # W > 128
    (2, 16, 16, 8, 8, 5),      # row 5 past the clamp
]


@pytest.mark.parametrize("shape", FUSED_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:5]))
                         + ("-clamp" if s[5] is not None else ""))
def test_fused_twin_matches_interpreted_pallas(shape):
    *dims, clamp_row = shape
    x, om_k, om_b, wgt, bias, g = fused_operands(1, *dims,
                                                 clamp_row=clamp_row)
    xj = jnp.asarray(x, jnp.bfloat16)
    out_j, stat_j = dcn_v2_pallas_lanes_fused(
        xj, om_k, om_b, jnp.asarray(wgt, jnp.bfloat16), bias,
        max_shift=PALLAS_MAX_SHIFT, interpret=True)
    grads_j = dcn_v2_pallas_bwd_lanes_fused(
        xj, om_k, om_b, jnp.asarray(wgt, jnp.bfloat16),
        jnp.asarray(g, jnp.bfloat16), max_shift=PALLAS_MAX_SHIFT,
        interpret=True)

    leaves = [nchw(x, torch.bfloat16), oihw(om_k), torch.tensor(om_b),
              oihw(wgt), torch.tensor(bias)]
    for t in leaves:
        t.requires_grad_(True)
    out, stat = dcn_v2_fused_twin(*leaves)
    assert out.dtype == torch.bfloat16 and stat.dtype == torch.float32
    got = torch.autograd.grad(out, leaves, nchw(g, torch.bfloat16))

    close(nhwc(out), np.asarray(out_j, np.float32), "out")
    assert float(stat) == pytest.approx(float(stat_j), rel=1e-5)
    assert got[0].dtype == torch.bfloat16
    close(nhwc(got[0]), np.asarray(grads_j[0], np.float32), "dx")
    close(hwio(got[1]), np.asarray(grads_j[1]), "d om_kernel")
    close(got[2].numpy(), np.asarray(grads_j[2]), "d om_bias")
    close(hwio(got[3]), np.asarray(grads_j[3]), "dW")
    close(got[4].numpy(), np.asarray(grads_j[4]), "dbias")
    if clamp_row is not None:
        assert float(stat) > PALLAS_MAX_SHIFT
        # the clamp passes no dy gradient: input channel 0 is nonzero on the
        # clamped row only, so the centre-tap weight from it to tap 0's dy
        # (which only that row feeds) gets exactly zero on both sides
        assert float(got[1][0, 0, 1, 1]) == 0.0
        assert float(np.asarray(grads_j[1])[1, 1, 0, 0]) == 0.0


def test_zero_init_is_half_the_conv_plus_bias():
    """The reference's zero-initialised offset conv: offsets 0 and mask
    sigmoid(0) = 0.5, so the layer is 0.5 x the plain conv plus the
    (unmodulated) bias, and max |dy| is 0."""
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.randn(2, 8, 10, 12).astype(np.float32)).bfloat16()
    wgt = torch.tensor((rng.randn(6, 8, 3, 3) * 0.1).astype(np.float32))
    bias = torch.tensor(rng.randn(6).astype(np.float32))
    out, stat = dcn_v2_fused_twin(x, torch.zeros(27, 8, 3, 3),
                                  torch.zeros(27), wgt, bias)
    want = 0.5 * torch.nn.functional.conv2d(
        x.float(), wgt.bfloat16().float(), padding=1) + bias.view(1, -1, 1, 1)
    torch.testing.assert_close(out.float(), want, rtol=TOL, atol=TOL)
    assert float(stat) == 0.0


def test_fused_kernel_path_on_cpu_is_the_twin():
    """A CPU tensor takes the fused twin, launches nothing, and the
    autograd Function's gradients are autograd's through the twin, with
    dbias = sum(g) in f32."""
    x, om_k, om_b, wgt, bias, g = fused_operands(4, 1, 6, 7, 4, 5)
    leaves = [nchw(x, torch.bfloat16), oihw(om_k), torch.tensor(om_b),
              oihw(wgt), torch.tensor(bias)]
    for t in leaves:
        t.requires_grad_(True)
    gt = nchw(g, torch.bfloat16)
    dcn_cuda.reset_launches()
    out, stat = dcn_cuda.dcn_v2_fused_kernel(*leaves)
    got = torch.autograd.grad(out, leaves, gt)
    assert all(v == 0 for v in dcn_cuda.LAUNCHES.values())
    assert not stat.requires_grad
    ref, ref_stat = dcn_v2_fused_twin(*leaves)
    want = torch.autograd.grad(ref, leaves, gt)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert float(stat) == float(ref_stat)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert got[4].dtype == torch.float32


def test_fused_wrappers_check_dtypes_on_cpu():
    """The fused wrappers take bf16 x; the float32 wrappers keep rejecting
    anything but f32 (a CUDA tensor is checked before any launch; on the
    CPU only the twin runs, so this checks the shared shape/dtype guard)."""
    x, om_k, om_b, wgt, bias, _ = fused_operands(5, 1, 6, 6, 4, 4)
    args = (nchw(x), oihw(om_k), torch.tensor(om_b), oihw(wgt),
            torch.tensor(bias))
    with pytest.raises(TypeError, match="bfloat16"):
        dcn_cuda._check_fused(*args)
    with pytest.raises(TypeError, match="float32"):
        dcn_cuda._check(args[0].bfloat16(), torch.zeros(1, 18, 6, 6),
                        torch.zeros(1, 9, 6, 6), args[3], args[4])
    shape = dcn_cuda._check_fused(args[0].bfloat16(), *args[1:])
    assert shape == (1, 4, 6, 6, 4)


def test_dcn_module_bf16_matches_jax_fused():
    """``DCN(dtype=bfloat16, impl="cuda")`` against the JAX ``DCN`` on its
    fused Pallas path: output (bf16 on both sides), the clamp monitor, dx
    and every parameter gradient."""
    rng = np.random.RandomState(2)
    b, h, w, cin, cout = 2, 16, 16, 8, 7
    x = np.asarray(jnp.asarray(rng.randn(b, h, w, cin), jnp.bfloat16),
                   np.float32)
    jmod = jax_dcn.DCN(cout, use_pallas=True, dtype=jnp.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0),
                                                xj)["params"])
    om_b = np.zeros(27, np.float32)
    om_b[:18] = 0.4 + rng.rand(18) * 0.2
    om_b[18:] = rng.randn(9) * 0.5
    params["conv_offset_mask"] = {
        "kernel": (rng.randn(3, 3, cin, 27) * 1e-3).astype(np.float32),
        "bias": om_b}
    params["bias"] = rng.randn(cout).astype(np.float32)
    g = np.asarray(jnp.asarray(rng.randn(b, h, w, cout), jnp.bfloat16),
                   np.float32)

    def jfn(p, x):
        out, inter = jmod.apply({"params": p}, x, mutable=["intermediates"])
        return out, inter["intermediates"]["max_abs_dy"][0]

    (want, stat_j), vjp = jax.vjp(jfn, params, xj)
    assert want.dtype == jnp.bfloat16
    dparams, dx_want = vjp((jnp.asarray(g, jnp.bfloat16),
                            jnp.zeros_like(stat_j)))

    mod = DCN(cin, cout, impl="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        mod.weight.copy_(oihw(params["weight"]))
        mod.bias.copy_(torch.tensor(params["bias"]))
        mod.conv_offset_mask.weight.copy_(
            oihw(params["conv_offset_mask"]["kernel"]))
        mod.conv_offset_mask.bias.copy_(torch.tensor(om_b))
    xt = nchw(x).requires_grad_(True)  # f32 in, cast by the module
    out = mod(xt)
    assert out.dtype == torch.bfloat16
    out.backward(nchw(g, torch.bfloat16))

    close(nhwc(out), np.asarray(want, np.float32), "out")
    assert float(mod.max_abs_dy) == pytest.approx(float(stat_j), rel=1e-5)
    close(nhwc(xt.grad), np.asarray(dx_want, np.float32), "dx")
    close(hwio(mod.weight.grad), np.asarray(dparams["weight"]), "dW")
    close(mod.bias.grad.numpy(), np.asarray(dparams["bias"]), "dbias")
    close(hwio(mod.conv_offset_mask.weight.grad),
          np.asarray(dparams["conv_offset_mask"]["kernel"]), "d om_kernel")
    close(mod.conv_offset_mask.bias.grad.numpy(),
          np.asarray(dparams["conv_offset_mask"]["bias"]), "d om_bias")
    for p in mod.parameters():
        assert p.grad.dtype == torch.float32
