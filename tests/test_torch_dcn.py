"""The port's DCN ops against the JAX package's (CPU, float32).

- the exact ``dcn_v2`` against ``centernet_uda_tpu.ops.dcn.dcn_v2`` on the
  output and all five gradients: the same f32 arithmetic in another order,
  so 1e-4 (relative to each tensor's scale);
- the plain kernel twin (forward, and autograd through it for the
  backward) against the interpreted Pallas lanes kernels
  ``dcn_v2_pallas_lanes`` / ``dcn_v2_pallas_bwd_lanes``, with |dy| > 14
  and off-map corners: 5e-2, the bound of the Pallas kernels' own tests
  (both stage bf16, in different places);
- the ``DCN`` module with bridged weights against the JAX ``DCN``.

Inputs are numpy arrays from a seed; NCHW <-> NHWC at the boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_uda_tpu.ops import dcn as jax_dcn
from centernet_uda_tpu.ops.dcn_pallas import (
    dcn_v2_pallas_bwd_lanes,
    dcn_v2_pallas_lanes,
)
from centernet_uda_torch import resolve_device
from centernet_uda_torch.ops import dcn_cuda
from centernet_uda_torch.ops.dcn import (
    DCN,
    PALLAS_MAX_SHIFT,
    dcn_v2,
    dcn_v2_twin,
    uses_kernel_path,
)

torch.set_num_threads(2)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def hwio(t):
    return t.detach().numpy().transpose(2, 3, 1, 0)


def operands(seed, b, h, w, cin, cout, k=9, ho=None, wo=None, off_std=2.0):
    rng = np.random.RandomState(seed)
    ho, wo = ho or h, wo or w
    x = rng.randn(b, h, w, cin).astype(np.float32)
    off = (rng.randn(b, ho, wo, 2 * k) * off_std).astype(np.float32)
    m = rng.rand(b, ho, wo, k).astype(np.float32)
    wt = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    g = rng.randn(b, ho, wo, cout).astype(np.float32)
    return x, off, m, wt, bias, g


def close(got, want, tol, name):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=name)


@pytest.mark.parametrize("stride,padding,dilation", [
    (1, 1, 1), (2, 1, 1), (1, 2, 2)])
def test_exact_op_matches_jax(stride, padding, dilation):
    b, h, w, cin, cout = 2, 9, 11, 5, 6
    ho = (h + 2 * padding - (2 * dilation + 1)) // stride + 1
    wo = (w + 2 * padding - (2 * dilation + 1)) // stride + 1
    x, off, m, wt, bias, g = operands(0, b, h, w, cin, cout, ho=ho, wo=wo)
    off[:, 0, :, 0] = 17.0  # far offsets stay exact (no clamp here)

    def jfn(*a):
        return jax_dcn.dcn_v2(*a, stride=stride, padding=padding,
                              dilation=dilation)

    want, vjp = jax.vjp(jfn, x, off, m, wt, bias)
    want_grads = vjp(jnp.asarray(g))

    leaves = [nchw(x), nchw(off), nchw(m), oihw(wt), torch.tensor(bias)]
    for t in leaves:
        t.requires_grad_(True)
    out = dcn_v2(*leaves, stride=stride, padding=padding, dilation=dilation)
    got_grads = torch.autograd.grad(out, leaves, nchw(g))

    close(nhwc(out), np.asarray(want), 1e-4, "out")
    for name, gg, wg in zip(("dx", "doff", "dmask"), got_grads[:3],
                            want_grads[:3]):
        close(nhwc(gg), np.asarray(wg), 1e-4, name)
    close(hwio(got_grads[3]), np.asarray(want_grads[3]), 1e-4, "dw")
    close(got_grads[4].numpy(), np.asarray(want_grads[4]), 1e-4, "db")


@pytest.mark.parametrize("b,h,w", [(1, 8, 16), (2, 8, 12)])
def test_twin_matches_interpreted_pallas_lanes(b, h, w):
    x, off, m, wt, bias, g = operands(1, b, h, w, 8, 8)
    off[:, 0, :, 0] = 20.0            # dy beyond the clamp
    off[:, h - 1, :, 8] = -15.0       # dy beyond the clamp, other tap
    off[:, :, 0, 3] = -3.0            # dx: corners left of the map
    want = np.asarray(dcn_v2_pallas_lanes(x, off, m, wt, bias,
                                          max_shift=PALLAS_MAX_SHIFT,
                                          interpret=True))
    want_grads = dcn_v2_pallas_bwd_lanes(x, off, m, wt, g,
                                         max_shift=PALLAS_MAX_SHIFT,
                                         interpret=True)
    args = (nchw(x), nchw(off), nchw(m), oihw(wt))
    out = dcn_v2_twin(*args, torch.tensor(bias))
    dx, doff, dmask, dw = dcn_cuda.dcn_backward_plain(*args, nchw(g))

    close(nhwc(out), want, 5e-2, "out")
    close(nhwc(dx), np.asarray(want_grads[0]), 5e-2, "dx")
    close(nhwc(doff), np.asarray(want_grads[1]), 5e-2, "doff")
    close(nhwc(dmask), np.asarray(want_grads[2]), 5e-2, "dmask")
    close(hwio(dw), np.asarray(want_grads[3]), 5e-2, "dw")
    close(nchw(g).sum((0, 2, 3)).numpy(), np.asarray(want_grads[4]), 5e-2,
          "db")
    # the clamp passes no dy gradient
    assert float(np.abs(nhwc(doff)[:, 0, :, 0]).max()) == 0.0


def test_dcn_module_matches_jax():
    rng = np.random.RandomState(2)
    b, h, w, cin, cout = 2, 8, 10, 6, 7
    x = rng.randn(b, h, w, cin).astype(np.float32)
    jmod = jax_dcn.DCN(cout, use_pallas=False)
    params = jax.tree.map(np.asarray,
                          jmod.init(jax.random.PRNGKey(0), x)["params"])
    params["conv_offset_mask"] = {
        "kernel": (rng.randn(3, 3, cin, 27) * 0.2).astype(np.float32),
        "bias": (rng.randn(27) * 0.2).astype(np.float32)}
    g = rng.randn(b, h, w, cout).astype(np.float32)

    def jfn(p, x):
        return jmod.apply({"params": p}, x)

    want, vjp = jax.vjp(jfn, params, x)
    dparams, dx_want = vjp(jnp.asarray(g))

    mod = DCN(cin, cout, impl="xla")
    with torch.no_grad():
        mod.weight.copy_(oihw(params["weight"]))
        mod.bias.copy_(torch.tensor(params["bias"]))
        mod.conv_offset_mask.weight.copy_(
            oihw(params["conv_offset_mask"]["kernel"]))
        mod.conv_offset_mask.bias.copy_(
            torch.tensor(params["conv_offset_mask"]["bias"]))
    xt = nchw(x).requires_grad_(True)
    out = mod(xt)
    out.backward(nchw(g))
    close(nhwc(out), np.asarray(want), 1e-4, "out")
    close(nhwc(xt.grad), np.asarray(dx_want), 1e-4, "dx")
    close(hwio(mod.weight.grad), np.asarray(dparams["weight"]), 1e-4, "dw")
    close(hwio(mod.conv_offset_mask.weight.grad),
          np.asarray(dparams["conv_offset_mask"]["kernel"]), 1e-4, "dw_om")
    assert mod.max_abs_dy is None  # no monitor off the kernel path


def test_module_init_and_monitor():
    mod = DCN(4, 5, impl="cuda")
    assert float(mod.conv_offset_mask.weight.detach().abs().max()) == 0.0
    assert float(mod.weight.detach().abs().max()) <= 1 / 6.0
    with torch.no_grad():
        # offset channel 2t = dy = -3, 2t+1 = dx = 10 for every tap
        mod.conv_offset_mask.bias[0:18:2] = -3.0
        mod.conv_offset_mask.bias[1:18:2] = 10.0
        mod(torch.randn(1, 4, 6, 6))
    # the monitor reads the dy channels only
    assert float(mod.max_abs_dy) == 3.0


@pytest.mark.parametrize("impl,kernel", [
    ("auto", False), ("cuda", True), ("pallas", True), ("xla", False)])
def test_impl_dispatch_on_cpu_tensors(impl, kernel):
    x, w3 = torch.zeros(1, 2, 4, 4), torch.zeros(3, 2, 3, 3)
    assert uses_kernel_path(impl, x, w3) is kernel
    # outside 3x3 / s1 / p1 / d1 the exact op runs whatever the setting
    assert not uses_kernel_path(impl, x, w3, stride=2)
    assert not uses_kernel_path(impl, x, torch.zeros(3, 2, 5, 5))


def test_impl_rejects_unknown():
    with pytest.raises(ValueError):
        uses_kernel_path("triton", torch.zeros(1, 2, 4, 4),
                         torch.zeros(3, 2, 3, 3))


def test_kernel_path_on_cpu_is_the_twin():
    """A CPU tensor takes the plain twin, launches nothing, and the
    autograd Function's gradients are autograd's through the twin."""
    x, off, m, wt, bias, g = operands(3, 1, 6, 7, 4, 5)
    leaves = [nchw(x), nchw(off), nchw(m), oihw(wt), torch.tensor(bias)]
    for t in leaves:
        t.requires_grad_(True)
    dcn_cuda.reset_launches()
    out = dcn_cuda.dcn_v2_kernel(*leaves)
    got = torch.autograd.grad(out, leaves, nchw(g))
    assert all(v == 0 for v in dcn_cuda.LAUNCHES.values())
    ref = dcn_v2_twin(*leaves)
    want = torch.autograd.grad(ref, leaves, nchw(g))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_cuda_default_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
