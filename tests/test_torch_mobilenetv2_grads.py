"""The port's MobileNetV2 against the JAX package's (CPU): the parameter
gradients in float32, and the heads at bfloat16.

The model, input size and bridged init are ``tests/test_torch_mobilenetv2.py``'s
(full width, 64 px, batch 2; DCN maps 2, 4 and 8 px wide: select, select,
lanes). The gradient is that of sum(heads * cotangent) for a seeded
cotangent, for every parameter.

Tolerances.
- Exact path, eval mode (BatchNorm an affine map): the same f32
  arithmetic in another order, 1e-4 of each tensor's scale (measured
  4e-7).
- Exact path, train mode: flax's one-pass BatchNorm variance carries f32
  noise through the backward of every train-mode BatchNorm (the port's f32
  gradients lie within 5.7e-5 of its own float64 run on the heads' first
  conv where JAX's lie 2.2 % away). So the norm of each tensor's
  difference is held at 5e-2 of the tensor's norm (measured 2.3 %), or of
  1e-3 of the largest tensor norm for the biases whose gradient is zero in
  exact arithmetic (those feeding a train-mode BatchNorm through linear
  layers only): there both sides hold rounding noise.
- Kernel path, eval mode: each side stages x, the weight and the samples
  in bf16 in its own places; at the layer both sides agree within 0.3 % in
  norm (dx, doffset, dmask, dW), but an f32 error of 3e-3 of a feature
  map's largest value is large against its typical entries, and the
  products that make the upstream gradients inherit it: measured up to
  9.5 % in norm per tensor, held at 2e-1; over all parameters together,
  held at 5e-2.
- bf16 heads (eval mode, kernel path: the select route with its explicit
  bf16 offset conv at W = 2 and 4, the fused route at W = 8): atol 5e-2 of
  the head's scale and rtol 5e-2, ``tests/test_torch_bf16.py``'s eval-mode
  bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_uda_torch.ops.dcn import DCN
from test_torch_mobilenetv2 import (  # noqa: F401 (a fixture)
    HEADS,
    SIZE,
    TOL,
    JaxMobileNetV2,
    image,
    jax_impl,
    jax_setup,
    nchw,
    nhwc,
    port_model,
    state_dict_from_jax,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("impl,train", [("xla", False), ("xla", True),
                                        ("cuda", False)],
                         ids=["xla-eval", "xla-train", "cuda-eval"])
def test_param_grads_match_jax(jax_setup, impl, train):
    module, variables = jax_setup
    x = image(5)
    rng = np.random.RandomState(6)
    cot = {k: rng.randn(x.shape[0], SIZE // 4, SIZE // 4, c).astype(
        np.float32) for k, c in HEADS.items()}
    jax_impl(impl)

    def loss(params):
        out = module.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, x,
                           train=train,
                           mutable=["batch_stats"] if train else False)
        out = out[0] if train else out
        return sum(jnp.sum(out[k] * cot[k]) for k in HEADS)

    grads = jax.jit(jax.grad(loss))(variables["params"])
    want = {k: v.numpy() for k, v in state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, grads)}, "mobilenetv2").items()}
    net = port_model(variables, impl).train(train)
    out = net(nchw(x))
    sum((out[k] * nchw(cot[k])).sum() for k in HEADS).backward()
    got = {k: p.grad.numpy() for k, p in net.named_parameters()}
    assert set(got) == set(want)
    if impl == "xla" and not train:
        for k, ref in want.items():
            np.testing.assert_allclose(
                got[k], ref, rtol=1e-4,
                atol=1e-4 * max(np.abs(ref).max(), 1e-6), err_msg=k)
        return
    norms = {k: np.linalg.norm(ref) for k, ref in want.items()}
    floor = 1e-3 * max(norms.values())
    tol = 5e-2 if impl == "xla" else 2e-1
    for k, ref in want.items():
        err = np.linalg.norm(got[k] - ref)
        assert err <= tol * max(norms[k], floor), (k, err, norms[k])
    if impl == "cuda":
        flat = lambda d: np.concatenate([d[k].ravel() for k in sorted(d)])
        total = np.linalg.norm(flat(got) - flat(want))
        assert total <= TOL * np.linalg.norm(flat(want)), total


def test_bf16_heads_match_jax(jax_setup):
    module, variables = jax_setup
    x = image(7)
    jax_impl("cuda")
    jmod = JaxMobileNetV2(heads=HEADS, use_dcn=True, use_skip=True,
                          dtype=jnp.bfloat16)
    want = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(variables, x)
    net = port_model(variables, "cuda", torch.bfloat16).eval()
    dtypes = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: dtypes.append(out.dtype))
        for m in net.modules() if isinstance(m, DCN)]
    with torch.no_grad():
        got = net(nchw(x))
    for h in hooks:
        h.remove()
    # every route of the kernel path gives x's dtype
    assert dtypes == [torch.bfloat16] * 3
    for k in want:
        ref = np.asarray(want[k])
        assert ref.dtype == np.float32 and got[k].dtype == torch.float32
        np.testing.assert_allclose(nhwc(got[k]), ref, rtol=TOL,
                                   atol=TOL * max(1.0, np.abs(ref).max()),
                                   err_msg=k)
