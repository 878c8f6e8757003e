"""The port's deformable PS-RoI pooling against the JAX package's (CPU).

``dcn_v2_pooling`` with and without offsets (``no_trans``), group sizes 1
and 2, ``trans_std`` 0.1 and a ``part_size`` below the pooled size, forward
and the gradients of ``x`` and ``trans``; ``DCNPooling`` with its three
fully connected layers from bridged weights (``fc3`` randomised, so the
offsets and the mask are not the zero init's), forward and gradients. The
JAX package returns the pooled bins channels-last; the tests transpose.
Both sides compute the same float32 gathers and sums, in other orders:
forward within 1e-5 and gradients within 1e-5 of their scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_uda_tpu.ops.dcn_pooling import DCNPooling as JaxDCNPooling
from centernet_uda_tpu.ops.dcn_pooling import dcn_v2_pooling as jax_pooling
from centernet_uda_torch.ops.dcn_pooling import (
    DCNPooling,
    DCNv2Pooling,
    dcn_v2_pooling,
)
from centernet_uda_torch.utils.weights import pooling_state_dict_from_jax

torch.set_num_threads(2)

TOL = 1e-5
ROIS = np.array([[0, 2, 2, 10, 12], [1, 0, 0, 15, 15], [0, 5, 7, 9, 9],
                 [1, 13.6, 1.2, 40.0, 6.5]], np.float32)


def inputs(seed, output_dim, group, pooled, part):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 16, 16, output_dim * group * group).astype(np.float32)
    trans = rng.randn(len(ROIS), 2, part, part).astype(np.float32)
    return x, trans


def nchw(x):
    return torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def assert_close(got, want, name):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=name)


CASES = [
    # (no_trans, group_size, output_dim, pooled_size, part_size, trans_std)
    (True, 1, 4, 3, None, 0.0),
    (True, 2, 4, 4, None, 0.0),
    (False, 1, 4, 3, None, 0.1),
    (False, 2, 4, 4, 2, 0.1),
    (False, 2, 3, 4, None, 0.25),
]


@pytest.mark.parametrize("no_trans,group,output_dim,pooled,part,trans_std",
                         CASES)
def test_pooling_matches_jax(no_trans, group, output_dim, pooled, part,
                             trans_std):
    x, trans = inputs(0, output_dim, group, pooled, part or pooled)
    # 2 offset classes where the output channels split in two
    if not no_trans and output_dim % 2 == 0:
        trans = np.concatenate([trans, -trans], 1)
    args = (0.5, pooled, output_dim, no_trans, group, part, 4, trans_std)

    def jax_fn(x, trans):
        return jax_pooling(x, jnp.asarray(ROIS), None if no_trans else trans,
                           *args)

    want = jax_fn(jnp.asarray(x), jnp.asarray(trans))
    xt = nchw(x).requires_grad_(True)
    tt = torch.tensor(trans).requires_grad_(True)
    got = dcn_v2_pooling(xt, torch.tensor(ROIS), None if no_trans else tt,
                         *args)
    assert got.shape == (len(ROIS), output_dim, pooled, pooled)
    assert_close(got.detach().numpy().transpose(0, 2, 3, 1), want, "out")

    # gradients of a weighted sum, so every bin's gradient differs
    coef = np.random.RandomState(1).randn(*np.asarray(want).shape).astype(
        np.float32)
    gx, gt = jax.grad(lambda x, t: (jax_fn(x, t) * coef).sum(),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(trans))
    (got * torch.tensor(coef.transpose(0, 3, 1, 2))).sum().backward()
    assert_close(xt.grad.numpy().transpose(0, 2, 3, 1), gx, "dx")
    assert float(xt.grad.abs().sum()) > 0
    if no_trans:
        assert tt.grad is None
    else:
        assert_close(tt.grad.numpy(), gt, "dtrans")
        assert float(tt.grad.abs().sum()) > 0


def test_constant_planes_pool_to_their_constant():
    """The reference's ``check_pooling_zero_offset`` property."""
    x = torch.zeros(1, 2, 12, 12)
    x[:, 0], x[:, 1] = 3.5, -1.25
    out = DCNv2Pooling(1.0, 3, 2, True)(x, torch.tensor([[0, 1, 1, 9, 9.]]))
    assert torch.allclose(out[:, 0], torch.tensor(3.5))
    assert torch.allclose(out[:, 1], torch.tensor(-1.25))


@pytest.mark.parametrize("no_trans", [False, True])
def test_dcn_pooling_module_matches_jax(no_trans):
    output_dim, group, pooled = 4, 2, 4
    x, _ = inputs(2, output_dim, group, pooled, pooled)
    module = JaxDCNPooling(spatial_scale=0.5, pooled_size=pooled,
                           output_dim=output_dim, no_trans=no_trans,
                           group_size=group, trans_std=0.1, deform_fc_dim=32)
    params = jax.tree.map(np.asarray, module.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ROIS)).get(
            "params", {}))
    port = DCNPooling(0.5, pooled, output_dim, no_trans, group,
                      trans_std=0.1, deform_fc_dim=32)
    if not no_trans:
        rng = np.random.RandomState(3)
        for leaf in ("kernel", "bias"):
            shape = params["fc3"][leaf].shape
            params["fc3"][leaf] = (rng.randn(*shape) * 0.2).astype(
                np.float32)
        port.load_state_dict(pooling_state_dict_from_jax(params))
    else:
        assert not params and not list(port.parameters())

    def jax_fn(params, x):
        return module.apply({"params": params}, x, jnp.asarray(ROIS))

    want = jax_fn(params, jnp.asarray(x))
    xt = nchw(x).requires_grad_(True)
    got = port(xt, torch.tensor(ROIS))
    assert_close(got.detach().numpy().transpose(0, 2, 3, 1), want, "out")

    coef = np.random.RandomState(4).randn(*np.asarray(want).shape).astype(
        np.float32)
    gp, gx = jax.grad(lambda p, x: (jax_fn(p, x) * coef).sum(),
                      argnums=(0, 1))(params, jnp.asarray(x))
    (got * torch.tensor(coef.transpose(0, 3, 1, 2))).sum().backward()
    assert_close(xt.grad.numpy().transpose(0, 2, 3, 1), gx, "dx")
    if not no_trans:
        want_grads = pooling_state_dict_from_jax(
            jax.tree.map(np.asarray, gp))
        for name, p in port.named_parameters():
            assert_close(p.grad.numpy(), want_grads[name].numpy(), name)


def test_dcn_pooling_starts_at_half_the_plain_pooling():
    """flax's init (and the reference's) zeroes ``fc3``: no offsets and a
    mask of sigmoid(0), so the module is half the offset-free pooling."""
    x = torch.randn(2, 16, 16, 16, generator=torch.Generator().manual_seed(0))
    port = DCNPooling(0.5, 4, 4, False, 2, trans_std=0.1, deform_fc_dim=16,
                      generator=torch.Generator().manual_seed(1))
    rois = torch.tensor(ROIS)
    base = dcn_v2_pooling(x, rois, None, 0.5, 4, 4, True, 2)
    torch.testing.assert_close(port(x, rois), base * 0.5)
