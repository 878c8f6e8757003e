"""The port's DLASeg against the JAX package's, from one bridged init.

A narrow DLA (channels (4, 8, 8, 16, 16, 32), one level each, head_conv 8)
at 64 px, batch 2, built in JAX, bridged with ``state_dict_from_jax`` and
run in both frameworks on the same numpy input (NCHW <-> NHWC at the
boundary), with the exact DCN op on both sides. Both run float32 on the
CPU; the tolerances (stated per assertion) cover summation-order noise of
f32 convolutions, which grows through the 30-odd layers and, in the
gradients, through the backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_uda_tpu.models import common as jax_common
from centernet_uda_tpu.models.dla import DLASeg as JaxDLASeg
from centernet_uda_tpu.models.dla import DepthwiseUp as JaxDepthwiseUp
from centernet_uda_tpu.ops import dcn as jax_dcn
from centernet_uda_torch.models.common import BatchNorm2d
from centernet_uda_torch.models.dla import (
    DLA34_CHANNELS,
    DLASeg,
    DepthwiseUp,
    build,
)
from centernet_uda_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

HEADS = {"hm": 3, "wh": 2, "reg": 2}
NARROW = dict(levels=(1, 1, 1, 1, 1, 1), channels=(4, 8, 8, 16, 16, 32),
              head_conv=8)


@pytest.fixture(scope="module")
def jax_model():
    old = jax_dcn.get_pallas_default(), jax_common.get_bn_groups()
    jax_dcn.set_pallas_default(False)
    jax_common.set_bn_groups(1)
    module = JaxDLASeg(heads=HEADS, **NARROW)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    variables = jax.jit(lambda k, x: module.init(k, x, train=False))(
        jax.random.PRNGKey(3), x)
    variables = jax.tree.map(np.asarray, variables)
    # nonzero offset convs, so the deformable sampling is exercised
    rng = np.random.RandomState(1)

    def perturb(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        if "conv_offset_mask" in names:
            return (rng.randn(*leaf.shape) * 0.05).astype(np.float32)
        return leaf

    variables["params"] = jax.tree_util.tree_map_with_path(
        perturb, variables["params"])
    yield module, variables
    jax_dcn.set_pallas_default(old[0])
    jax_common.set_bn_groups(old[1])


def port_model(variables):
    net = DLASeg(HEADS, dcn_impl="xla", **NARROW)
    net.load_state_dict(state_dict_from_jax(variables))
    return net


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


@pytest.mark.parametrize("train", [False, True])
def test_heads_match_jax(jax_model, train):
    module, variables = jax_model
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    if train:
        want, _ = module.apply(variables, x, train=True,
                               mutable=["batch_stats"])
    else:
        want = module.apply(variables, x, train=False)
    net = port_model(variables).train(train)
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert set(got) == set(want)
    for k in want:
        ref = np.asarray(want[k])
        # f32 on both sides; eval-mode features are small at init, so an
        # absolute bound relative to the map's scale
        np.testing.assert_allclose(nhwc(got[k]), ref, rtol=1e-3,
                                   atol=1e-4 * max(1.0, np.abs(ref).max()),
                                   err_msg=k)


def test_bn_running_stats_match_jax(jax_model):
    """One train forward updates the running stats as flax does: momentum
    0.9 (torch 0.1) and the BIASED batch variance."""
    module, variables = jax_model
    x = np.random.RandomState(4).randn(2, 64, 64, 3).astype(np.float32)
    _, new_state = module.apply(variables, x, train=True,
                                mutable=["batch_stats"])
    want = state_dict_from_jax({"batch_stats": new_state["batch_stats"]})
    net = port_model(variables).train()
    with torch.no_grad():
        net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    got = net.state_dict()
    assert len(want) > 40
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        # running stats are averages of f32 activations: 1e-4 relative
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_param_grads_match_jax(jax_model):
    module, variables = jax_model
    rng = np.random.RandomState(5)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    proj = {k: rng.randn(2, 16, 16, c).astype(np.float32)
            for k, c in HEADS.items()}

    def loss_fn(params):
        out, _ = module.apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              x, train=True, mutable=["batch_stats"])
        return sum(jnp.sum(out[k] * proj[k]) for k in HEADS)

    grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)})

    net = port_model(variables).train()
    out = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    loss = sum((out[k] * torch.from_numpy(
        proj[k].transpose(0, 3, 1, 2).copy())).sum() for k in HEADS)
    loss.backward()
    params = dict(net.named_parameters())
    assert set(params) == set(want)
    top = max(float(v.abs().max()) for v in want.values())
    for k, v in want.items():
        ref = v.numpy()
        # f32 gradients through ~30 layers of BN-normalised convs: 2e-3 of
        # each tensor's scale, floored at 1e-5 of the largest gradient (a
        # bias feeding a train-mode BN has gradient 0 up to that noise)
        np.testing.assert_allclose(
            params[k].grad.numpy(), ref, rtol=2e-3,
            atol=max(2e-3 * np.abs(ref).max(), 1e-5 * top), err_msg=k)


def test_init_mirrors_flax():
    """Heatmap bias -2.19, zero offset convs, DCN weights within
    +-1/sqrt(9 Cin), BN at scale 1 / bias 0, bilinear upsampling, and the
    same seed giving the same parameters."""
    a = build(num_classes=2, device="cpu", dcn_impl="xla", seed=5,
              **NARROW).module
    b = build(num_classes=2, device="cpu", dcn_impl="xla", seed=5,
              **NARROW).module
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    np.testing.assert_allclose(sa["hm.2.bias"].numpy(), -2.19)
    assert float(sa["wh.2.bias"].abs().max()) == 0.0
    w = sa["dla_up.ida_0.proj_1.conv.weight"]
    assert float(w.abs().max()) <= 1.0 / np.sqrt(9 * w.shape[1]) + 1e-7
    assert float(sa["dla_up.ida_0.proj_1.conv.conv_offset_mask.weight"]
                 .abs().max()) == 0.0
    assert float(sa["base.base_layer.1.weight"].min()) == 1.0
    # lecun-normal: truncated at 2 std of 1/sqrt(fan_in)
    k = sa["base.base_layer.0.weight"]
    assert float(k.abs().max()) <= 2 * np.sqrt(1 / 147) / 0.8796 + 1e-6
    assert isinstance(a.base.level2.root.bn, BatchNorm2d)


def test_full_width_keys_match_jax_tree():
    """DLA-34 at full width: the port's state dict has exactly the keys
    the JAX variables bridge to (shapes via eval_shape, no compile)."""
    module = JaxDLASeg(heads=HEADS)
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)), train=False))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_jax(variables)
    net = DLASeg(HEADS, channels=DLA34_CHANNELS, dcn_impl="xla")
    own = net.state_dict()
    assert set(sd) == set(own)
    for k in own:
        assert tuple(sd[k].shape) == tuple(own[k].shape), k


@pytest.mark.parametrize("factor", [2, 4])
def test_depthwise_up_matches_jax(factor):
    rng = np.random.RandomState(factor)
    x = rng.randn(1, 5, 5, 3).astype(np.float32)
    mod = JaxDepthwiseUp(channels=3, factor=factor)
    kernel = rng.randn(2 * factor, 2 * factor, 1, 3).astype(np.float32)
    want = np.asarray(mod.apply({"params": {"kernel": kernel}}, x))
    up = DepthwiseUp(3, factor)
    with torch.no_grad():
        up.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)
                                         .copy()))
        got = up(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-5, atol=1e-5)
