"""The port's EfficientNet backend against the JAX package's, from one
bridged init (CPU).

b0 with skips (the ``keypoints`` experiment's backbone) in eval and train
mode with the BatchNorm statistics after the train forward, b0 with the
``use_upsample`` neck, b1 (depth scaling: 23 blocks), b3 by structure only
(the ``coco_merged`` backbone: names and shapes against the JAX tree), bf16
heads, eval-mode parameter gradients and the weight bridge's round trip
through the JAX package's importer.
``tests/test_torch_efficientnet_trainer.py`` holds three train steps
against the JAX trainer and the trainer's stochastic-depth generator.

Stochastic depth. Its masks cannot match JAX's bits, so the parity tests
run both sides without it, as JAX does when ``apply`` gets no ``dropout``
rng (the port: no ``drop_generator``). It is tested on its own: the rate
per block and ``x / keep * mask`` with a given mask here, eval mode and
the masks per seed and step with the trainer.

The JAX BatchNorm statistics and scales are randomised before the
comparison. Tolerances: f32 heads within 1e-4 of a head's scale,
BatchNorm statistics within 1e-4, bf16 heads within a median of 5e-2 and a
maximum of 3e-1 of a head's scale. Gradients within 2e-3 of each
parameter's gradient scale: against the port run in float64 on the same
weights and input (on the CPU, for this file) JAX's are within 1.2e-6 and
the port's f32 within 1.4e-3, at ``wh.0.weight``, whose gradient sums
2 x 16 x 16 products that nearly cancel (-0.8581 against -0.8632 in
float64 at one element, on a scale of 3.64): the f32 accumulation order of
torch's CPU convolution backward, not a difference of function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_uda_tpu.models import common as jax_common
from centernet_uda_tpu.models import efficientnet as jax_effnet
from centernet_uda_tpu.utils.torch_import import import_state_dict
from centernet_uda_torch.models import efficientnet as effnet
from centernet_uda_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

HEADS = {"hm": 3, "wh": 2, "reg": 2}
BATCH, SIZE = 2, 64
CASES = {"b0_skip": ("b0", dict(use_skip=True)),
         "b0_upsample": ("b0", dict(use_upsample=True)),
         "b1_skip": ("b1", dict(use_skip=True))}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def image(seed, size=SIZE):
    return np.random.RandomState(seed).randn(BATCH, size, size, 3).astype(
        np.float32)


def randomise_bn(variables, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = getattr(path[-1], "key", "")
        where = jax.tree_util.keystr(path)
        if "bn" not in where:
            return x
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (rng.randn(*x.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def jax_models():
    old = jax_common.get_bn_groups()
    jax_common.set_bn_groups(1)
    out = {}
    for i, (case, (variant, kw)) in enumerate(CASES.items()):
        module = jax_effnet.CenterEfficientNet(variant=variant, heads=HEADS,
                                               **kw)
        variables = jax.jit(lambda k, x, m=module: m.init(k, x, train=False))(
            jax.random.PRNGKey(i), image(0))
        out[case] = (module, randomise_bn(jax.tree.map(np.asarray, variables),
                                          i))
    yield out
    jax_common.set_bn_groups(old)


def port_model(case, variables, dtype=torch.float32):
    variant, kw = CASES[case]
    net = effnet.CenterEfficientNet(variant, HEADS, dtype=dtype, **kw)
    net.load_state_dict(state_dict_from_jax(variables,
                                            f"efficientnet-{variant}"))
    return net


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", list(CASES))
def test_heads_match_jax(jax_models, case, train):
    module, variables = jax_models[case]
    x = image(2)
    want = jax.jit(lambda v, x: module.apply(
        v, x, train=train, mutable=["batch_stats"] if train else False))(
            variables, x)
    if train:
        want, new_state = want
    net = port_model(case, variables).train(train)
    assert net.drop_generator is None  # no stochastic depth
    with torch.no_grad():
        got = net(nchw(x))
    for k in HEADS:
        w = np.asarray(want[k])
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(nhwc(got[k]), w,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
    if train:
        stats = state_dict_from_jax(
            {"params": variables["params"],
             "batch_stats": jax.tree.map(np.asarray,
                                         new_state["batch_stats"])},
            f"efficientnet-{CASES[case][0]}")
        for key, value in net.state_dict().items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(value.numpy(), stats[key].numpy(),
                                           rtol=1e-4, atol=1e-4,
                                           err_msg=key)


def test_structure_of_b0_b1():
    """Blocks per variant (depth scaling) and the skip sources."""
    assert len(effnet.block_specs("b0")) == 16
    assert len(effnet.block_specs("b1")) == 23
    net = effnet.CenterEfficientNet("b1", HEADS, use_skip=True)
    assert net.skip_map == {1: 7, 0: 15}
    assert net.skip_2[0].in_channels == 112 and net.skip_5[0].in_channels == 40


def test_b3_matches_jax_structure():
    """Every JAX leaf of b3 with skips and rotated + keypoint heads maps to
    a port entry of the same shape, without running either model."""
    heads = {"hm": 6, "wh": 3, "reg": 2, "kps": 10}
    module = jax_effnet.CenterEfficientNet(variant="b3", heads=heads,
                                           use_skip=True)
    shapes = jax.eval_shape(lambda k, x: module.init(k, x, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_jax(zeros, "efficientnet-b3")
    net = effnet.build(6, "b3", num_keypoints=5, rotated_boxes=True,
                       use_skip=True, device="cpu").module
    own = net.state_dict()
    assert set(own) == set(sd)
    for key, value in own.items():
        assert tuple(value.shape) == tuple(sd[key].shape), key
    n_jax = sum(x.size for x in jax.tree.leaves(zeros["params"]))
    assert sum(p.numel() for p in net.parameters()) == n_jax


def test_gradients_match_jax(jax_models):
    """d(sum of the heads times fixed random weights)/d(params), b0 with
    skips, eval mode."""
    module, variables = jax_models["b0_skip"]
    x = image(3)
    rng = np.random.RandomState(4)
    coef = {k: rng.randn(BATCH, 16, 16, c).astype(np.float32)
            for k, c in HEADS.items()}

    def jloss(params):
        out = module.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, x,
                           train=False)
        return sum(jnp.sum(out[k] * coef[k]) for k in HEADS)

    jgrads = jax.jit(jax.grad(jloss))(variables["params"])
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads)},
                               "efficientnet-b0")
    net = port_model("b0_skip", variables).eval()
    out = net(nchw(x))
    sum((out[k] * nchw(coef[k])).sum() for k in HEADS).backward()
    named = dict(net.named_parameters())
    assert set(named) == set(want)
    for key, p in named.items():
        w = want[key].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w,
                                   atol=2e-3 * np.abs(w).max(), err_msg=key)


def test_bf16_heads_match_jax(jax_models):
    _, variables = jax_models["b0_skip"]
    jmod = jax_effnet.CenterEfficientNet(variant="b0", heads=HEADS,
                                         use_skip=True, dtype=jnp.bfloat16)
    x = image(5)
    want = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(variables, x)
    net = port_model("b0_skip", variables, torch.bfloat16).eval()
    with torch.no_grad():
        got = net(nchw(x))
    for k in HEADS:
        w = np.asarray(want[k], np.float32)
        assert got[k].dtype == torch.float32
        err = np.abs(nhwc(got[k]) - w) / np.abs(w).max()
        assert np.median(err) < 5e-2 and err.max() < 3e-1, k


@pytest.mark.parametrize("case", ["b0_skip", "b0_upsample"])
def test_bridge_round_trip(jax_models, case, tmp_path):
    """JAX variables -> the port's state dict -> ``torch.save`` -> the JAX
    package's ``import_state_dict(..., "efficientnet-b0")``: every leaf
    comes back exactly."""
    _, variables = jax_models[case]
    net = port_model(case, variables)
    path = tmp_path / "effnet.pth"
    torch.save(net.state_dict(), path)
    blank = jax.tree.map(np.zeros_like, variables)
    back = import_state_dict(path, blank, "efficientnet-b0")
    flat_want = jax.tree_util.tree_leaves_with_path(variables)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_got) > 200
    for path_, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path_]), leaf,
                                      err_msg=jax.tree_util.keystr(path_))


# --- stochastic depth -----------------------------------------------------------


def test_drop_rates_per_block():
    net = effnet.CenterEfficientNet("b0", HEADS)
    rates = [b.drop_rate for b in net.base._blocks]
    assert rates == [0.2 * i / 16 for i in range(16)]


def test_drop_connect_formula():
    x = torch.randn(4, 3, 2, 2)
    mask = torch.tensor([1.0, 0.0, 1.0, 0.0]).view(4, 1, 1, 1)
    got = effnet.drop_connect(x, 0.8, mask)
    torch.testing.assert_close(got[0], x[0] / 0.8)
    assert torch.count_nonzero(got[1]) == 0
    want = jax.numpy.asarray(x.numpy()) / 0.8 * jnp.asarray(mask.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
