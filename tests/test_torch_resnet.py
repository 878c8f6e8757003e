"""The port's ResNet backend against the JAX package's, from one bridged
init (CPU).

ResNet-18 and ResNet-50 at full width: heads in eval and train mode at 64
and 80 px, the BatchNorm running statistics after a train forward,
parameter gradients, bf16 heads, three train steps of
``experiment=baseline_resnet18`` against the JAX trainer, and the weight
bridge's round trip through the JAX package's own importer. ResNet-101 and
-152 are checked by structure only (names and shapes against the JAX
tree).

The stride-2 3x3 convs pad ``"SAME"`` from each input's size. At 64 px they
see 16, 8 and 4 px maps (even: (0, 1)); at 80 px 20, 10 (even) and 5 (odd:
(1, 1)), so the padding is asymmetric at two stages and symmetric at the
third. (96 px gives 24, 12 and 6, all even.)

The JAX BatchNorm statistics and scales are randomised before the
comparison, so eval mode does not run an identity BN. Tolerances: f32
heads within 1e-4 of a head's scale, BatchNorm statistics within 1e-4,
gradients within 1e-4 of each parameter's gradient scale, bf16 heads
within a median of 5e-2 and a maximum of 3e-1 of a head's scale
(``tests/test_torch_bf16.py``), three steps of losses within 1e-3 at lr
1e-4 (``tests/test_torch_uda_twins.py`` says why).

Where train-mode BatchNorm meets the deepest maps (2 x 2 or 3 x 3 at
batch 2), flax's one-pass variance (E[x^2] - E[x]^2, ROADMAP Queue C) puts
f32 noise into JAX's results. Measured against the port run in float64 on
the same weights and input (on the CPU, for this file): ResNet-50's
train-mode heads, JAX 5.7e-4 to 7.0e-4 of scale, the port's f32 1.0e-4 to
2.1e-4 (a 2048-channel BN over 8 values a channel); ResNet-18's train-mode
gradients, JAX up to 28.7 % of a parameter's gradient scale at 80 px
(``deconv_layers.0.weight``) and 3.7 % at 128 px (``hm.0.weight``), the
port's f32 6.7e-6 at 128 px (2.7e-3 at 80 px, whose 3 x 3 bottom cancels
in its two-pass BN too). So ResNet-50's train-mode heads are held at 2e-3
of scale, the gradients against JAX in eval mode and against the port's
own float64 run in train mode (at 128 px), and the
trajectory runs at 128 px, where the deepest maps are 4 x 4 (the losses
part from JAX's by up to 6.4e-3 at 64 px, 1.8e-3 at 96 px and 7.0e-4 at
128 px by the third step).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_uda_tpu import config as jax_config
from centernet_uda_tpu.losses.centernet import DetectionLoss as JaxLoss
from centernet_uda_tpu.models import common as jax_common
from centernet_uda_tpu.models import resnet as jax_resnet
from centernet_uda_tpu.uda.base import Model as JaxModel
from centernet_uda_tpu.utils.torch_import import import_state_dict
from centernet_uda_torch.config import compose
from centernet_uda_torch.models import common, resnet
from centernet_uda_torch.models.common import SameConv2d, same_padding
from centernet_uda_torch.ops.gaussian import encode_targets
from centernet_uda_torch.train import build_trainer
from centernet_uda_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

HEADS = {"hm": 3, "wh": 2, "reg": 2}
BATCH = 2


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def image(seed, size):
    return np.random.RandomState(seed).randn(BATCH, size, size, 3).astype(
        np.float32)


def randomise_bn(variables, seed):
    """Random BN scales, shifts and running statistics."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = getattr(path[-1], "key", "")
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("bias", "mean") and "bn" in jax.tree_util.keystr(path):
            return (rng.randn(*x.shape) * 0.1).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def jax_models():
    old = jax_common.get_bn_groups()
    jax_common.set_bn_groups(1)
    out = {}
    for layers in (18, 50):
        module = jax_resnet.CenterResNet(num_layers=layers, heads=HEADS)
        variables = jax.jit(lambda k, x, m=module: m.init(k, x, train=False))(
            jax.random.PRNGKey(layers), image(0, 64))
        out[layers] = (module, randomise_bn(
            jax.tree.map(np.asarray, variables), layers))
    yield out
    jax_common.set_bn_groups(old)


def port_model(variables, layers, dtype=torch.float32):
    net = resnet.CenterResNet(layers, HEADS, dtype=dtype)
    net.load_state_dict(state_dict_from_jax(variables, f"resnet{layers}"))
    return net


def jax_apply(module, variables, x, train):
    out = jax.jit(lambda v, x: module.apply(
        v, x, train=train, mutable=["batch_stats"] if train else False))(
            variables, x)
    return out if train else (out, None)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("size", [64, 80])
@pytest.mark.parametrize("layers", [18, 50])
def test_heads_match_jax(jax_models, layers, size, train):
    module, variables = jax_models[layers]
    x = image(size, size)
    want, _ = jax_apply(module, variables, x, train)
    net = port_model(variables, layers).train(train)
    with torch.no_grad():
        got = net(nchw(x))
    assert set(got) == set(HEADS)
    tol = 2e-3 if (train and layers == 50) else 1e-4
    for k in HEADS:
        w = np.asarray(want[k])
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(nhwc(got[k]), w,
                                   atol=tol * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("layers", [18, 50])
def test_bn_running_stats_match_jax(jax_models, layers):
    """The running statistics after one train forward at 64 px."""
    module, variables = jax_models[layers]
    x = image(6, 64)
    _, new_state = jax_apply(module, variables, x, True)
    net = port_model(variables, layers).train()
    with torch.no_grad():
        net(nchw(x))
    want = state_dict_from_jax(
        {"params": variables["params"],
         "batch_stats": jax.tree.map(np.asarray, new_state["batch_stats"])},
        f"resnet{layers}")
    n = 0
    for key, value in net.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            n += 1
            np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=key)
    assert n > 40


def test_same_padding_at_80px(jax_models):
    """XLA's split: (0, 1) on an even map, (1, 1) on an odd one; at 80 px
    the stride-2 convs see both."""
    assert same_padding(20, 3, 2) == (0, 1)
    assert same_padding(5, 3, 2) == (1, 1)
    assert same_padding(64, 5, 2) == (1, 2)
    assert same_padding(7, 3, 1) == (1, 1)
    net = port_model(jax_models[18][1], 18).eval()
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append(args[0].shape[-1]))
        for m in net.modules() if isinstance(m, SameConv2d)]
    with torch.no_grad():
        net(nchw(image(1, 80)))
    for h in hooks:
        h.remove()
    assert seen == [20, 10, 5]


def float64_twin(net):
    """The same model computing in float64 throughout, as a reference for
    f32 rounding."""
    twin = copy.deepcopy(net).double()
    for p in twin.parameters():
        p.grad = None
    for mod in twin.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    return twin


def head_grads(net, x, coef, dtype=torch.float32):
    out = net(nchw(x).to(dtype))
    sum((out[k] * nchw(coef[k]).to(dtype)).sum() for k in HEADS).backward()
    return {k: p.grad.double().numpy() for k, p in net.named_parameters()}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_gradients_match(jax_models, train):
    """d(sum of the heads times fixed random weights)/d(params), ResNet-18:
    in eval mode at 80 px against JAX's, in train mode at 128 px against
    the port's float64 run (JAX's carry its BatchNorm noise there, see
    above)."""
    module, variables = jax_models[18]
    size, out = (128, 32) if train else (80, 24)
    x = image(3, size)
    rng = np.random.RandomState(4)
    coef = {k: rng.randn(BATCH, out, out, c).astype(np.float32)
            for k, c in HEADS.items()}
    net = port_model(variables, 18).train(train)
    got = head_grads(net, x, coef)
    if train:
        want = head_grads(float64_twin(net).train(), x, coef, torch.float64)
    else:
        def jloss(params):
            out = module.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               x, train=False)
            return sum(jnp.sum(out[k] * coef[k]) for k in HEADS)

        jgrads = jax.jit(jax.grad(jloss))(variables["params"])
        want = {k: v.numpy() for k, v in state_dict_from_jax(
            {"params": jax.tree.map(np.asarray, jgrads)},
            "resnet18").items()}
    assert set(got) == set(want)
    for key, g in got.items():
        w = want[key]
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(),
                                   err_msg=key)


def test_bf16_heads_match_jax(jax_models):
    module, variables = jax_models[18]
    jmod = jax_resnet.CenterResNet(num_layers=18, heads=HEADS,
                                   dtype=jnp.bfloat16)
    x = image(5, 64)
    want = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(variables, x)
    net = port_model(variables, 18, torch.bfloat16).eval()
    with torch.no_grad():
        got = net(nchw(x))
    for k in HEADS:
        w = np.asarray(want[k], np.float32)
        assert got[k].dtype == torch.float32
        err = np.abs(nhwc(got[k]) - w) / np.abs(w).max()
        assert np.median(err) < 5e-2 and err.max() < 3e-1, k


def test_bridge_round_trip(jax_models, tmp_path):
    """JAX variables -> the port's state dict -> ``torch.save`` -> the JAX
    package's ``import_state_dict(..., "resnet")``: every leaf comes back
    exactly (the transposed-conv kernels flipped twice)."""
    for layers in (18, 50):
        _, variables = jax_models[layers]
        net = port_model(variables, layers)
        path = tmp_path / f"resnet{layers}.pth"
        torch.save(net.state_dict(), path)
        blank = jax.tree.map(np.zeros_like, variables)
        back = import_state_dict(path, blank, f"resnet{layers}")
        flat_want = jax.tree_util.tree_leaves_with_path(variables)
        flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_want) == len(flat_got) > 100
        for path_, leaf in flat_want:
            np.testing.assert_array_equal(
                np.asarray(flat_got[path_]), leaf,
                err_msg=jax.tree_util.keystr(path_))


@pytest.mark.parametrize("kind", ["deconv", "upsample"])
def test_necks_match_jax(kind):
    """``deconv_neck`` and ``upsample_conv_neck`` against the JAX
    package's ``DeconvNeck`` and ``UpsampleConvNeck`` (train-mode BN), 64
    channels at 4 x 4 up to 32 x 32."""
    module = (jax_common.DeconvNeck((16, 16, 16)) if kind == "deconv"
              else jax_common.UpsampleConvNeck((16, 16, 16)))
    x = np.random.RandomState(8).randn(BATCH, 4, 4, 64).astype(np.float32)
    variables = jax.tree.map(np.asarray, module.init(
        jax.random.PRNGKey(0), x, train=False))
    want, _ = module.apply(variables, x, train=True, mutable=["batch_stats"])
    net = (common.deconv_neck(64, (16, 16, 16)) if kind == "deconv"
           else common.upsample_conv_neck(64, (16, 16, 16))).train()
    per_stage = 3 if kind == "deconv" else 4
    sd = {}
    for name, leaves in variables["params"].items():
        stage = int(name[-1])
        if name.startswith("bn"):
            idx = per_stage * stage + per_stage - 2
            sd[f"{idx}.weight"] = torch.tensor(leaves["scale"])
            sd[f"{idx}.bias"] = torch.tensor(leaves["bias"])
        else:  # deconv: (4, 4, in, out), flipped; upconv: HWIO
            w = leaves["kernel"]
            w = (np.transpose(w, (2, 3, 0, 1))[..., ::-1, ::-1]
                 if kind == "deconv" else np.transpose(w, (3, 2, 0, 1)))
            sd[f"{per_stage * stage + (kind != 'deconv')}.weight"] = (
                torch.tensor(np.ascontiguousarray(w)))
    net.load_state_dict(sd, strict=False)
    with torch.no_grad():
        got = net(nchw(x))
    w = np.asarray(want)
    assert got.shape == (BATCH, 16, 32, 32)
    np.testing.assert_allclose(nhwc(got), w, atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("layers", [101, 152])
def test_deep_variants_match_jax_structure(layers):
    """Every JAX leaf maps to a port entry of the same shape and back,
    without running either model."""
    module = jax_resnet.CenterResNet(num_layers=layers, heads=HEADS)
    shapes = jax.eval_shape(lambda k, x: module.init(k, x, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_jax(zeros, f"resnet{layers}")
    net = resnet.build(layers, 3, device="cpu").module
    own = net.state_dict()
    assert set(own) == set(sd)
    for key, value in own.items():
        assert tuple(value.shape) == tuple(sd[key].shape), key
    n_jax = sum(x.size for x in jax.tree.leaves(zeros["params"]))
    assert sum(p.numel() for p in net.parameters()) == n_jax


# --- three train steps against the JAX trainer --------------------------------

SIZE, MAX_DET = 128, 20
OVERRIDES = ["experiment=baseline_resnet18", f"max_detections={MAX_DET}",
             f"batch_size={BATCH}",
             f"datasets.training.params.input_size=[{SIZE},{SIZE}]",
             "model.backend.params.num_classes=3",
             "optimizer.params.lr=0.0001"]


def make_batch(seed):
    rng = np.random.RandomState(seed)
    out = SIZE // 4
    per_image = []
    for _ in range(BATCH):
        n = rng.randint(2, 6)
        xy = rng.rand(n, 2) * out * 0.7
        boxes = np.concatenate([xy, xy + rng.rand(n, 2) * out * 0.3 + 1], 1)
        per_image.append(encode_targets(boxes, rng.randint(0, 3, n), out, out,
                                        3, MAX_DET))
    data = {k: np.stack([t[k] for t in per_image]) for k in per_image[0]}
    data["input"] = rng.randn(BATCH, 3, SIZE, SIZE).astype(np.float32)
    data["id"] = np.arange(BATCH)
    return data


def to_jax(data):
    out = dict(data)
    out["input"] = np.ascontiguousarray(data["input"].transpose(0, 2, 3, 1))
    out["hm"] = np.ascontiguousarray(data["hm"].transpose(0, 2, 3, 1))
    return out


def test_three_steps_match_jax_trainer():
    old = jax_common.get_bn_groups()
    jax_common.set_bn_groups(1)
    try:
        jcfg = jax_config.compose(OVERRIDES)
        jm = JaxModel()
        jm.cfg = jcfg
        jm.backend = jax_resnet.build(18, 3)
        jm.centernet_loss = JaxLoss(**jcfg.model.backend.loss.params.to_dict())
        jm.optimizer_cfg = jcfg.optimizer.to_dict()
        jm.init_done()
        port = build_trainer(compose(OVERRIDES), device="cpu")
        port.init_done()
        port.backend.module.load_state_dict(state_dict_from_jax(
            {"params": jax.tree.map(np.asarray, jm.state.params),
             "batch_stats": jax.tree.map(np.asarray, jm.state.batch_stats)},
            "resnet18"))
        previous = None
        for seed in range(3):
            data = make_batch(seed)
            want = jm.step(to_jax(data), is_training=True)["stats"]
            got = port.step(data, is_training=True)["stats"]
            assert set(got) == set(want)
            for k in ("hm_loss", "wh_loss", "off_loss", "total_loss"):
                assert float(got[k]) == pytest.approx(float(want[k]),
                                                      rel=1e-3), (seed, k)
            assert float(got["total_loss"]) != previous
            previous = float(got["total_loss"])
    finally:
        jax_common.set_bn_groups(old)
