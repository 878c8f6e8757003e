"""The weight bridge round trip: JAX variables -> ``state_dict_from_jax`` ->
``torch.save`` -> the JAX package's own ``import_state_dict`` gives back the
original variables leaf for leaf (exactly: the bridge only transposes).
The variable tree comes from ``jax.eval_shape``, so nothing is compiled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_uda_tpu.models.dla import DLASeg as JaxDLASeg
from centernet_uda_tpu.utils.torch_import import import_state_dict
from centernet_uda_torch.models.dla import DLASeg
from centernet_uda_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

HEADS = {"hm": 3, "wh": 2, "reg": 2}


def _random_variables(module, seed):
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            train=False))
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("channels,levels", [
    ((4, 8, 8, 16, 16, 32), (1, 1, 1, 1, 1, 1)),
    ((4, 8, 8, 16, 16, 32), (1, 1, 1, 2, 2, 1)),
])
def test_round_trip_through_jax_importer(tmp_path, channels, levels):
    module = JaxDLASeg(heads=HEADS, channels=channels, levels=levels,
                       head_conv=8)
    original = _random_variables(module, seed=11)
    fresh = jax.tree.map(np.zeros_like, original)

    sd = state_dict_from_jax(original)
    # the state dict loads strictly into the port's model
    net = DLASeg(HEADS, channels=channels, levels=levels, head_conv=8,
                 dcn_impl="xla")
    net.load_state_dict(sd)
    path = tmp_path / "bridged.pth"
    torch.save(net.state_dict(), path)

    back = import_state_dict(str(path), fresh, "dla34")
    flat_a = jax.tree_util.tree_flatten_with_path(original)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b) > 50
    for key, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[key]), leaf,
                                      err_msg=jax.tree_util.keystr(key))


def test_layouts():
    """Conv kernels HWIO -> OIHW, the depthwise upsample (k, k, 1, o) ->
    (o, 1, k, k), BN leaves renamed."""
    module = JaxDLASeg(heads=HEADS, channels=(4, 8, 8, 16, 16, 32),
                       levels=(1, 1, 1, 1, 1, 1), head_conv=8)
    v = _random_variables(module, seed=3)
    sd = state_dict_from_jax(v)
    k = v["params"]["base"]["base_conv"]["kernel"]
    np.testing.assert_array_equal(sd["base.base_layer.0.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    up = v["params"]["ida_up"]["up_1"]["kernel"]
    assert up.shape[2] == 1
    np.testing.assert_array_equal(sd["ida_up.up_1.weight"].numpy()[:, 0],
                                  up[:, :, 0, :].transpose(2, 0, 1))
    np.testing.assert_array_equal(
        sd["dla_up.ida_0.proj_1.actf.0.running_var"].numpy(),
        v["batch_stats"]["dla_up"]["ida_0"]["proj_1"]["actf_bn"]["var"])
    np.testing.assert_array_equal(
        sd["hm.2.bias"].numpy(), v["params"]["hm_out"]["bias"])
