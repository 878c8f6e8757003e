"""The port's MobileNetV2 (``use_dcn``, ``use_skip``) against the JAX
package's, from one bridged init (CPU).

Full width (the 1280-channel trunk, the 256-channel DCN neck, head_conv
64), 64 px, batch 2. The DCN maps are then W = 2 (Cin 1280), 4 and 8
(Cin 256): the first two take the "select" route, the third the lanes
route. Two implementations on each side: the exact op (``dcn_impl: xla``)
and the kernel path, where the port runs its kernels' plain twins (on a CPU
tensor) and the JAX package its Pallas kernels interpreted.

This file: the heads in eval and train mode, the BatchNorm running
statistics after a train forward, the routes, and the bridge's round trip
(the port's state dict, saved, imports back into the JAX package through
its own ``import_state_dict``). ``tests/test_torch_mobilenetv2_grads.py``
holds the parameter gradients and the bf16 heads,
``tests/test_torch_mobilenetv2_trainer.py`` three train steps.

Tolerances. Exact path, eval mode: the same f32 arithmetic in another
order, 1e-4 of the head's scale. Train mode: flax's BatchNorm takes the
variance as E[x^2] - E[x]^2 in one f32 pass, which cancels where a
channel's mean is large against its spread (the deepest layers have 8
values a channel at 2 x 2 px, batch 2), so JAX's batch statistics carry
f32 noise that the port's two-pass variance does not: the heads differ by
5e-4 of their scale, held at 2e-3 (the statistics likewise). Kernel path:
5e-2, the bound of the Pallas kernels' own tests (both stage bf16, in other
places; measured 3.6e-3 in eval mode, 6.4e-3 in train mode).
"""

import jax
import numpy as np
import pytest
import torch

from centernet_uda_tpu.models import common as jax_common
from centernet_uda_tpu.models.mobilenetv2 import (
    CenterMobileNetV2 as JaxMobileNetV2,
)
from centernet_uda_tpu.ops import dcn as jax_dcn
from centernet_uda_tpu.utils.torch_import import import_state_dict
from centernet_uda_torch.models.common import BatchNorm2d
from centernet_uda_torch.models.mobilenetv2 import CenterMobileNetV2, build
from centernet_uda_torch.ops import dcn_cuda
from centernet_uda_torch.ops.dcn import DCN, kernel_route
from centernet_uda_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

HEADS = {"hm": 3, "wh": 2, "reg": 2}
SIZE, BATCH = 64, 2
TOL = 5e-2
IMPLS = ["xla", "cuda"]


def jax_impl(impl):
    """The JAX package's counterpart of a port ``dcn_impl``."""
    jax_dcn.set_pallas_default(impl == "cuda")


@pytest.fixture(scope="module")
def jax_setup():
    old = jax_dcn.get_pallas_default(), jax_common.get_bn_groups()
    jax_common.set_bn_groups(1)
    jax_impl("xla")
    module = JaxMobileNetV2(heads=HEADS, use_dcn=True, use_skip=True)
    x = np.random.RandomState(0).randn(BATCH, SIZE, SIZE, 3).astype(
        np.float32)
    variables = jax.jit(lambda k, x: module.init(k, x, train=False))(
        jax.random.PRNGKey(0), x)
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


def port_model(variables, impl, dtype=torch.float32):
    net = CenterMobileNetV2(HEADS, use_dcn=True, use_skip=True,
                            dcn_impl=impl, dtype=dtype)
    net.load_state_dict(state_dict_from_jax(variables, "mobilenetv2"))
    return net


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def image(seed):
    return np.random.RandomState(seed).randn(BATCH, SIZE, SIZE, 3).astype(
        np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("impl", IMPLS)
def test_heads_match_jax(jax_setup, impl, train):
    module, variables = jax_setup
    x = image(2)
    jax_impl(impl)
    want = jax.jit(lambda v, x: module.apply(
        v, x, train=train, mutable=["batch_stats"] if train else False))(
            variables, x)
    if train:
        want = want[0]
    net = port_model(variables, impl).train(train)
    dcn_cuda.reset_launches()
    with torch.no_grad():
        got = net(nchw(x))
    assert all(v == 0 for v in dcn_cuda.LAUNCHES.values())
    tol = TOL if impl == "cuda" else (2e-3 if train else 1e-4)
    assert set(got) == set(want)
    for k in want:
        ref = np.asarray(want[k])
        np.testing.assert_allclose(nhwc(got[k]), ref, rtol=tol,
                                   atol=tol * max(1.0, np.abs(ref).max()),
                                   err_msg=k)


def test_routes_at_64px(jax_setup):
    """At 64 px the neck's DCN maps are 2, 4 and 8 px wide: select,
    select, lanes; at bf16 the third is fused."""
    _, variables = jax_setup
    net = port_model(variables, "cuda")
    seen = []

    def record(mod, args):
        x = args[0]
        seen.append([kernel_route(tuple(x.shape), dt, tuple(
            mod.weight.shape)) for dt in (torch.float32, torch.bfloat16)])

    hooks = [m.register_forward_pre_hook(record) for m in net.modules()
             if isinstance(m, DCN)]
    with torch.no_grad():
        net(nchw(image(3)))
    for h in hooks:
        h.remove()
    assert seen == [["select", "select"], ["select", "select"],
                    ["lanes", "fused"]]


@pytest.mark.parametrize("impl", IMPLS)
def test_bn_running_stats_match_jax(jax_setup, impl):
    module, variables = jax_setup
    x = image(4)
    jax_impl(impl)
    _, new_state = jax.jit(lambda v, x: module.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    want = state_dict_from_jax({"batch_stats": new_state["batch_stats"]},
                               "mobilenetv2")
    net = port_model(variables, impl).train()
    with torch.no_grad():
        net(nchw(x))
    got = net.state_dict()
    n = sum(isinstance(m, BatchNorm2d) for m in net.modules())
    assert len(want) == 3 * n == 3 * 58
    tol = TOL if impl == "cuda" else 2e-3
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                got[k].numpy(), v.numpy(), rtol=tol,
                atol=tol * max(1.0, float(v.abs().max())), err_msg=k)


def test_bridge_round_trip(jax_setup, tmp_path):
    """JAX variables -> the port's state dict -> ``torch.save`` -> the JAX
    package's ``import_state_dict(..., "mobilenetv2")``: every leaf comes
    back exactly (the transposed-conv kernels flipped twice)."""
    _, variables = jax_setup
    sd = state_dict_from_jax(variables, "mobilenetv2")
    net = port_model(variables, "xla")
    assert set(sd) == set(net.state_dict())
    path = tmp_path / "mnv2.pth"
    torch.save(net.state_dict(), path)
    blank = jax.tree.map(np.zeros_like, variables)
    back = import_state_dict(path, blank, "mobilenetv2")
    flat_want = jax.tree_util.tree_leaves_with_path(variables)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_got) > 300
    for path_, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path_]), leaf,
                                      err_msg=jax.tree_util.keystr(path_))


def test_build_and_unported_options():
    backend = build(6, use_dcn=True, use_skip=True, device="cpu", seed=3)
    assert backend.name == "mobilenetv2" and backend.down_ratio == 4
    dcns = [m for m in backend.module.modules() if isinstance(m, DCN)]
    assert [m.weight.shape[1] for m in dcns] == [1280, 256, 256]
    again = build(6, use_dcn=True, use_skip=True, device="cpu", seed=3)
    for (k, a), b in zip(backend.module.state_dict().items(),
                         again.module.state_dict().values()):
        assert torch.equal(a, b), k
    # a trunk weight file that is not there; freeze_base: no gradient for
    # the trunk (tests/test_torch_freeze.py, test_torch_pretrained.py)
    with pytest.raises(FileNotFoundError, match="not found"):
        build(6, pretrained="w.pth", device="cpu")
    frozen = build(6, freeze_base=True, device="cpu").module
    assert {k.startswith("base.") for k, p in frozen.named_parameters()
            if not p.requires_grad} == {True}
    assert all(p.requires_grad for k, p in frozen.named_parameters()
               if not k.startswith("base."))
