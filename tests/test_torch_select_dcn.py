"""The port's select and wide routes against the JAX package's (CPU).

- ``dcn_v2_twin`` (the plain version of the select Hopper kernels) and, by
  autograd, its gradients against the Pallas kernels
  ``dcn_v2_pallas_select`` / ``dcn_v2_pallas_bwd_select`` run in interpret
  mode, with x (and g, out, dx, dW) in float32 and in bfloat16, at a narrow
  map and at Cin > 512 with W < 8, each with a row past the clamp;
- the clamp-dx twin (the wide forward's plain version) against
  ``_dcn_v2_pallas_wide`` (forced "lanes" at W = 300), and the wide
  route's backward, the exact op on clipped offsets, against JAX's;
- the routing functions (``generation_for``, ``pallas_supported``,
  ``fused_supported`` and the route they give) against the JAX package's
  over a grid of shapes, dtypes, geometries and all three kernel versions;
- the bf16 ``DCN`` module at W < 8 on the kernel path against JAX's: the
  select route with the explicit bf16 offset conv, on both sides.

Tolerance: atol 5e-2 * max(1, max|reference|) and rtol 5e-2, the bound of
the Pallas kernels' own tests (``tests/test_dcn_pallas.py``). Both sides
stage x, W and the samples in bf16; the Pallas kernels also round their
one-hot select weights (bilinear weight times mask) to bf16, which the
twin keeps in f32, and the two sum in other orders. The wide route's
backward is the same exact op on both sides: 1e-4.

Inputs are numpy arrays from a seed; NCHW <-> NHWC at the boundary.
"""

import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_uda_tpu.ops import dcn as jax_dcn
from centernet_uda_tpu.ops import dcn_pallas
from centernet_uda_tpu.ops.dcn_pallas import (
    _dcn_v2_pallas_wide,
    dcn_v2_pallas_bwd_select,
    dcn_v2_pallas_select,
)
from centernet_uda_torch.ops import dcn as port_dcn
from centernet_uda_torch.ops import dcn_cuda
from centernet_uda_torch.ops.dcn import (
    DCN,
    PALLAS_MAX_SHIFT,
    dcn_v2_twin,
    kernel_route,
)

torch.set_num_threads(2)

TOL = 5e-2
BF16 = {"float32": (torch.float32, jnp.float32),
        "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a, np.float32), -1, 1))).to(dtype)


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def oihw(w, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(w, np.float32).transpose(3, 2, 0, 1))).to(dtype)


def hwio(t):
    return t.detach().float().numpy().transpose(2, 3, 1, 0)


def close(got, want, name, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), name
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=name)


def operands(seed, b, h, w, cin, cout, clamp_row=None):
    """NHWC x, offsets of std 1.5 with fractional parts away from integers
    (a floor must not flip on f32 noise), mask, HWIO W, bias, g; values of
    x, W and g representable in bf16. With ``clamp_row`` dy of tap 0 is
    20 on that row."""
    rng = np.random.RandomState(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    x = bf(rng.randn(b, h, w, cin))
    off = (np.floor(rng.randn(b, h, w, 18) * 1.5)
           + 0.3 + 0.4 * rng.rand(b, h, w, 18)).astype(np.float32)
    if clamp_row is not None:
        off[:, clamp_row, :, 0] = 20.0
    m = rng.rand(b, h, w, 9).astype(np.float32)
    wgt = bf(rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin))
    bias = rng.randn(cout).astype(np.float32)
    g = bf(rng.randn(b, h, w, cout))
    return x, off, m, wgt, bias, g


SELECT_SHAPES = [
    # (b, h, w, cin, cout, clamp_row)
    (1, 6, 10, 24, 16, 1),
    (1, 4, 5, 520, 8, 0),   # Cin > 512 and W < 8
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SELECT_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:5])))
def test_select_twin_matches_interpreted_pallas(shape, dtype):
    *dims, clamp_row = shape
    tdt, jdt = BF16[dtype]
    x, off, m, wgt, bias, g = operands(0, *dims, clamp_row=clamp_row)
    xj, wj, gj = (jnp.asarray(a, jdt) for a in (x, wgt, g))
    out_j = dcn_v2_pallas_select(xj, off, m, wj, bias,
                                 max_shift=PALLAS_MAX_SHIFT, interpret=True)
    grads_j = dcn_v2_pallas_bwd_select(xj, off, m, wj, gj,
                                       max_shift=PALLAS_MAX_SHIFT,
                                       interpret=True)
    assert out_j.dtype == jdt and grads_j[0].dtype == jdt
    assert grads_j[3].dtype == jdt  # dW in the weight's dtype

    leaves = [nchw(x, tdt), nchw(off), nchw(m), oihw(wgt, tdt),
              torch.tensor(bias)]
    for t in leaves:
        t.requires_grad_(True)
    out = dcn_v2_twin(*leaves)
    got = torch.autograd.grad(out, leaves, nchw(g, tdt))
    assert out.dtype == got[0].dtype == got[3].dtype == tdt
    close(nhwc(out), np.asarray(out_j, np.float32), "out")
    close(nhwc(got[0]), np.asarray(grads_j[0], np.float32), "dx")
    close(nhwc(got[1]), np.asarray(grads_j[1]), "doffset")
    close(nhwc(got[2]), np.asarray(grads_j[2]), "dmask")
    close(hwio(got[3]), np.asarray(grads_j[3], np.float32), "dW")
    close(got[4].numpy(), np.asarray(grads_j[4]), "dbias")
    # the clamped row passes no dy gradient on either side
    row = nhwc(got[1])[:, clamp_row, :, 0]
    assert np.abs(row).max() == 0.0
    assert np.abs(np.asarray(grads_j[1])[:, clamp_row, :, 0]).max() == 0.0


def test_clamp_dx_twin_matches_interpreted_panels():
    """Forced "lanes" at W = 300: the Pallas panel-mode forward clamps dx as
    well as dy; so does the twin with ``clamp_dx``, and the unclamped twin
    differs there."""
    x, off, m, wgt, bias, _ = operands(1, 1, 8, 300, 8, 8)
    off[..., 1::2] *= 8.0  # dx past the clamp at many pixels
    want = np.asarray(_dcn_v2_pallas_wide(
        jnp.asarray(x), off, m, jnp.asarray(wgt), bias, PALLAS_MAX_SHIFT,
        True))
    args = (nchw(x), nchw(off), nchw(m), oihw(wgt), torch.tensor(bias))
    got = dcn_v2_twin(*args, clamp_dx=True)
    close(nhwc(got), want, "out")
    assert np.abs(nhwc(dcn_v2_twin(*args)) - want).max() > 0.5


def test_wide_route_backward_matches_jax():
    """Both sides differentiate the exact op on offsets clipped to +-14 at
    forced "lanes" W > 256 (``ops/dcn.py:_dcn_pallas_bwd``), and the port's
    autograd Function forwards the clamp-dx twin on the CPU."""
    x, off, m, wgt, bias, g = operands(2, 1, 4, 260, 4, 4)
    off[..., 1::2] *= 8.0
    old = dcn_pallas.get_kernel_version()
    dcn_pallas.set_kernel_version("lanes")
    try:
        _, vjp = jax.vjp(lambda *a: jax_dcn._dcn_pallas_op(*a), x, off, m,
                         wgt, bias)
        want = vjp(jnp.asarray(g))
    finally:
        dcn_pallas.set_kernel_version(old)
    leaves = [nchw(x), nchw(off), nchw(m), oihw(wgt), torch.tensor(bias)]
    for t in leaves:
        t.requires_grad_(True)
    dcn_cuda.reset_launches()
    out = dcn_cuda.dcn_v2_wide_kernel(*leaves)
    got = torch.autograd.grad(out, leaves, nchw(g))
    assert all(v == 0 for v in dcn_cuda.LAUNCHES.values())
    close(nhwc(out), nhwc(dcn_v2_twin(*[t.detach() for t in leaves],
                                      clamp_dx=True)), "out", 0.0)
    close(nhwc(got[0]), np.asarray(want[0]), "dx", 1e-4)
    close(nhwc(got[1]), np.asarray(want[1]), "doffset", 1e-4)
    close(nhwc(got[2]), np.asarray(want[2]), "dmask", 1e-4)
    close(hwio(got[3]), np.asarray(want[3]), "dW", 1e-4)
    close(got[4].numpy(), np.asarray(want[4]), "dbias", 1e-4)


def jax_route(x, w, stride, padding, dilation):
    """The route the JAX package's ``DCN`` takes on its Pallas path, from
    its own functions (``ops/dcn.py:520-584``, ``_dcn_pallas_bwd``)."""
    kh, kw, cin, cout = w.shape
    if not jax_dcn._pallas_supported(x, w, stride, padding, dilation):
        return None
    if jax_dcn._fused_supported(x, cin, cout, (kh, kw), stride, padding,
                                dilation):
        return "fused"
    if dcn_pallas.generation_for(x.shape) == "select":
        return "select"
    return ("wide" if x.shape[2] > dcn_pallas._LANES_NATIVE_MAX_W
            else "lanes")


GRID_HW = [(2, 2), (16, 7), (16, 8), (64, 16), (200, 200), (8, 256),
           (8, 257), (300, 300), (4, 1024), (4, 1100), (600, 64)]
GRID_C = [(64, 64), (512, 256), (513, 64), (1280, 256), (128, 1280)]
GEOMETRY = [(3, 1, 1, 1), (3, 2, 1, 1), (1, 1, 0, 1), (3, 1, 2, 2)]


@pytest.mark.parametrize("version", ["auto", "lanes", "select"])
def test_routing_matches_jax(version):
    old = dcn_pallas.get_kernel_version(), port_dcn.get_kernel_version()
    dcn_pallas.set_kernel_version(version)
    port_dcn.set_kernel_version(version)
    seen = set()
    try:
        for (h, w), (cin, cout), (k, s, p, d), dtype in itertools.product(
                GRID_HW, GRID_C, GEOMETRY, ["float32", "bfloat16"]):
            tdt, jdt = BF16[dtype]
            xj = jax.ShapeDtypeStruct((2, h, w, cin), jdt)
            wj = types.SimpleNamespace(shape=(k, k, cin, cout))
            shape = (2, cin, h, w)
            key = (h, w, cin, cout, k, s, p, d, dtype)
            assert port_dcn.generation_for(shape) == \
                dcn_pallas.generation_for(xj.shape), key
            assert port_dcn.pallas_supported(
                shape, (cout, cin, k, k), s, p, d) == \
                jax_dcn._pallas_supported(xj, wj, s, p, d), key
            assert port_dcn.fused_supported(shape, tdt, k, s, p, d) == \
                jax_dcn._fused_supported(xj, cin, cout, k, s, p, d), key
            route = kernel_route(shape, tdt, (cout, cin, k, k), s, p, d)
            assert route == jax_route(xj, wj, s, p, d), key
            seen.add(route)
    finally:
        dcn_pallas.set_kernel_version(old[0])
        port_dcn.set_kernel_version(old[1])
    want = {"auto": {None, "fused", "select", "lanes"},
            "lanes": {None, "fused", "lanes", "wide"},
            "select": {None, "select"}}[version]
    assert seen == want
    with pytest.raises(ValueError):
        port_dcn.set_kernel_version("bogus")


def test_bf16_dcn_module_below_8_columns_matches_jax():
    """The bf16 ``DCN`` at W = 6 on the kernel path: select, with the
    offset conv explicit in bf16 (om rounded to bf16) on both sides; out,
    dx and the parameter gradients in their dtypes."""
    rng = np.random.RandomState(3)
    b, h, w, cin, cout = 2, 10, 6, 8, 7
    x = np.asarray(jnp.asarray(rng.randn(b, h, w, cin), jnp.bfloat16),
                   np.float32)
    assert kernel_route((b, cin, h, w), torch.bfloat16,
                        (cout, cin, 3, 3)) == "select"
    jmod = jax_dcn.DCN(cout, use_pallas=True, dtype=jnp.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0),
                                                xj)["params"])
    params["conv_offset_mask"] = {
        "kernel": (rng.randn(3, 3, cin, 27) * 0.1).astype(np.float32),
        "bias": (rng.randn(27) * 0.5).astype(np.float32)}
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
        mod.conv_offset_mask.bias.copy_(
            torch.tensor(params["conv_offset_mask"]["bias"]))
    xt = nchw(x).requires_grad_(True)
    out = mod(xt)
    assert out.dtype == torch.bfloat16
    out.backward(nchw(g, torch.bfloat16))
    close(nhwc(out), np.asarray(want, np.float32), "out")
    # both monitor the bf16 offsets of the explicit conv
    assert float(mod.max_abs_dy) == pytest.approx(float(stat_j), rel=1e-2)
    close(nhwc(xt.grad), np.asarray(dx_want, np.float32), "dx")
    close(hwio(mod.weight.grad), np.asarray(dparams["weight"]), "dW")
    close(mod.bias.grad.numpy(), np.asarray(dparams["bias"]), "dbias")
    close(hwio(mod.conv_offset_mask.weight.grad),
          np.asarray(dparams["conv_offset_mask"]["kernel"]), "d om_kernel")
    close(mod.conv_offset_mask.bias.grad.numpy(),
          np.asarray(dparams["conv_offset_mask"]["bias"]), "d om_bias")
