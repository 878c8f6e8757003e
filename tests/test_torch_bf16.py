"""The port at ``precision: bfloat16`` against the JAX package's (CPU).

- a narrow DLASeg at bf16 (channels (4, 8, 8, 16, 16, 32), one level each,
  head_conv 8, 64 px, batch 2), bridged with ``state_dict_from_jax`` from
  the JAX ``DLASeg(dtype=bfloat16)``: the heads in train and eval mode, the
  BatchNorm running statistics after a train forward, and the dtypes (heads
  float32, trunk and neck bfloat16, parameters and statistics float32);
- three train steps of ``build_trainer`` at ``precision=bfloat16`` against
  the JAX ``Model`` on the same config and init, as
  ``tests/test_torch_slice.py`` does at float32; every ``.grad`` is f32.

Both sides run the exact DCN op (``dcn_impl: xla``): the JAX package's
explicit bf16 composition (offset conv in bf16, offsets and mask in f32,
the exact sampler on bf16 x, f32 contraction). The fused kernels' arithmetic
is held against the Pallas kernels in ``tests/test_torch_fused_dcn.py``.

Tolerances. The two frameworks round bf16 at different places: XLA on the
CPU fuses chains of bf16 elementwise ops (the sampler's corner sums, the
residual adds, BatchNorm's affine) and may keep them in f32 to the end of
the fusion, where PyTorch rounds after every op, and the convolutions sum in
other orders before rounding. (JAX alone shows it: the same bf16 model's
hm_loss differs by 0.2 % between its jitted step and op-by-op execution.)
Each difference is about one bf16 ulp (2^-8 = 0.4 % relative). In eval
mode they stay there (the port equals JAX's op-by-op result on the heatmap
head), so the heads are held at atol 5e-2 * max(1, max|ref|) and rtol
5e-2. In train mode BatchNorm renormalises each narrow layer by its batch
statistics and the differences grow through some 30 layers: JAX's jitted
and op-by-op forwards of the same bf16 model differ by up to 5.9 / 10.2 /
18.6 % of the hm / reg / wh head's largest value (medians 0.8 / 1.1 /
2.1 %), and the port differs from the jitted one by 6.4 / 10.5 / 21.5 %
(medians 0.7 / 1.1 / 2.1 %), as much as JAX from itself. So in train mode
the median difference is held at 5e-2 of the head's scale and the largest
at 3e-1. The running statistics are train-mode moments of the same
features, held the same way: per tensor, the median difference at 5e-2 and
the largest at 3e-1 of the batch's standard deviation (its square for the
variance); the deepest layers' batch variances differ most (16 % on one
channel of level5's root).

The trajectory. From the same weights the losses agree to 1 % on each of
the three batches (the forward through the whole slice); step 0 is held at
5e-2. The updates are another matter: on this narrow model the bf16
gradients carry rounding noise of the order of the gradients themselves,
through the bf16 cotangents of train-mode BatchNorm, whose mean and
projection subtraction cancel most of each gradient. JAX's own bf16
gradients differ from its f32 ones by a median 114 % of each tensor's scale
(the port's bf16 ones by 100 %), and Adam's first steps move every element
by about lr times the sign of its gradient, so the two sides take
different first steps and JAX's bf16 losses leave its f32 ones as far as
the port's leave JAX's. At the baseline's own lr (5e-5), after one and two
steps, the largest difference measured was 6.2 % (off_loss after one step:
port 0.4837, JAX bf16 0.4556, JAX f32 0.4677, which lies between them), so
steps 1 and 2 are held at 1e-1.
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from centernet_uda_tpu import config as jax_config
from centernet_uda_tpu.losses.centernet import DetectionLoss as JaxLoss
from centernet_uda_tpu.models import common as jax_common
from centernet_uda_tpu.models.dla import DLASeg as JaxDLASeg
from centernet_uda_tpu.ops import dcn as jax_dcn
from centernet_uda_tpu.uda.base import Model as JaxModel
from centernet_uda_torch.config import compose
from centernet_uda_torch.models.common import BatchNorm2d
from centernet_uda_torch.models.dla import DLASeg
from centernet_uda_torch.ops.dcn import DCN
from centernet_uda_torch.ops.gaussian import encode_targets
from centernet_uda_torch.train import build_trainer
from centernet_uda_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

HEADS = {"hm": 3, "wh": 2, "reg": 2}
LEVELS, CHANNELS, HEAD_CONV = (1, 1, 1, 1, 1, 1), (4, 8, 8, 16, 16, 32), 8
NUM_CLASSES, SIZE, BATCH, MAX_DET = 3, 64, 2, 20
TOL = 5e-2


@pytest.fixture(scope="module")
def exact_dcn():
    old = jax_dcn.get_pallas_default(), jax_common.get_bn_groups()
    jax_dcn.set_pallas_default(False)
    jax_common.set_bn_groups(1)
    yield
    jax_dcn.set_pallas_default(old[0])
    jax_common.set_bn_groups(old[1])


@pytest.fixture(scope="module")
def jax_model(exact_dcn):
    module = JaxDLASeg(heads=HEADS, levels=LEVELS, channels=CHANNELS,
                       head_conv=HEAD_CONV, dtype=jnp.bfloat16)
    x = np.random.RandomState(0).randn(2, SIZE, SIZE, 3).astype(np.float32)
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
    forward = {
        True: jax.jit(lambda v, x: module.apply(v, x, train=True,
                                                mutable=["batch_stats"])),
        False: jax.jit(lambda v, x: (module.apply(v, x, train=False), None)),
    }
    return forward, variables


def port_model(variables):
    net = DLASeg(HEADS, levels=LEVELS, channels=CHANNELS,
                 head_conv=HEAD_CONV, dcn_impl="xla", dtype=torch.bfloat16)
    net.load_state_dict(state_dict_from_jax(variables))
    return net


def nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


@pytest.mark.parametrize("train", [False, True])
def test_bf16_heads_match_jax(jax_model, train):
    forward, variables = jax_model
    x = np.random.RandomState(2).randn(2, SIZE, SIZE, 3).astype(np.float32)
    want, _ = forward[train](variables, x)
    net = port_model(variables).train(train)
    feats = {}

    def record(mod, args, out, key):
        feats[key] = out.dtype

    hooks = [m.register_forward_hook(
        lambda mod, args, out, key=name: record(mod, args, out, key))
        for name, m in net.named_modules()
        if isinstance(m, (DCN, BatchNorm2d))]
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for h in hooks:
        h.remove()
    assert set(got) == set(want)
    # the exact-path DCN gives f32 (as in JAX); BatchNorm gives bf16
    assert {d for k, d in feats.items() if k.endswith(".conv")} == {
        torch.float32}
    assert {d for k, d in feats.items() if not k.endswith(".conv")} == {
        torch.bfloat16}
    for k in want:
        ref = np.asarray(want[k])
        assert ref.dtype == np.float32 and got[k].dtype == torch.float32
        if not train:
            np.testing.assert_allclose(nhwc(got[k]), ref, rtol=TOL,
                                       atol=TOL * max(1.0, np.abs(ref).max()),
                                       err_msg=k)
            continue
        err = np.abs(nhwc(got[k]) - ref)
        scale = np.abs(ref).max()
        assert np.isfinite(err).all(), k
        assert np.median(err) <= TOL * scale, (k, np.median(err), scale)
        assert err.max() <= 3e-1 * scale, (k, err.max(), scale)


def test_bf16_bn_running_stats_match_jax(jax_model):
    forward, variables = jax_model
    x = np.random.RandomState(4).randn(2, SIZE, SIZE, 3).astype(np.float32)
    _, new_state = forward[True](variables, x)
    want = state_dict_from_jax({"batch_stats": new_state["batch_stats"]})
    net = port_model(variables).train()
    with torch.no_grad():
        net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    got = net.state_dict()
    assert len(want) > 40
    for k, v in want.items():
        if not k.endswith(("running_mean", "running_var")):
            continue
        assert got[k].dtype == torch.float32, k
        # running = 0.9 * prior + 0.1 * batch moment (prior mean 0, var 1)
        var = want[k.replace("running_mean", "running_var")].numpy()
        batch_var = float(np.maximum((var - 0.9) / 0.1, 0.0).max())
        unit = np.sqrt(batch_var) if k.endswith("mean") else batch_var
        err = np.abs(got[k].numpy() - v.numpy()) / 0.1
        assert np.median(err) <= TOL * unit + 1e-5, (k, np.median(err), unit)
        assert err.max() <= 3e-1 * unit + 1e-5, (k, err.max(), unit)


def test_bridge_loads_into_bf16_model(jax_model):
    """Parameters are f32 on both sides, so ``state_dict_from_jax`` needs
    no change for a bf16 model: every key loads, exactly, as f32."""
    _, variables = jax_model
    sd = state_dict_from_jax(variables)
    net = port_model(variables)
    own = net.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        assert own[k].dtype == v.dtype, k
        assert torch.equal(own[k], v), k


# ---------------------------------------------------------------------------
# three train steps of the whole slice
# ---------------------------------------------------------------------------

OVERRIDES = [
    "experiment=baseline", "precision=bfloat16", "dcn_impl=xla",
    f"max_detections={MAX_DET}", f"batch_size={BATCH}",
    f"datasets.training.params.input_size=[{SIZE},{SIZE}]",
    f"model.backend.params.num_classes={NUM_CLASSES}",
]
PORT_ONLY = [f"model.backend.params.levels={list(LEVELS)}",
             f"model.backend.params.channels={list(CHANNELS)}",
             f"model.backend.params.head_conv={HEAD_CONV}"]


def make_batch(seed):
    rng = np.random.RandomState(seed)
    out = SIZE // 4
    per_image = []
    for _ in range(BATCH):
        n = rng.randint(2, 6)
        xy = rng.rand(n, 2) * out * 0.7
        boxes = np.concatenate([xy, xy + rng.rand(n, 2) * out * 0.3 + 1], 1)
        per_image.append(encode_targets(boxes, rng.randint(0, NUM_CLASSES, n),
                                        out, out, NUM_CLASSES, MAX_DET))
    data = {k: np.stack([t[k] for t in per_image]) for k in per_image[0]}
    data["input"] = rng.randn(BATCH, 3, SIZE, SIZE).astype(np.float32)
    data["id"] = np.arange(BATCH)
    return data


def to_jax(data):
    out = dict(data)
    out["input"] = np.ascontiguousarray(data["input"].transpose(0, 2, 3, 1))
    out["hm"] = np.ascontiguousarray(data["hm"].transpose(0, 2, 3, 1))
    return out


@pytest.fixture(scope="module")
def trajectories(exact_dcn):
    jcfg = jax_config.compose(OVERRIDES)
    heads = jax_common.make_heads_dict(NUM_CLASSES, 0, False)
    jm = JaxModel()
    jm.cfg = jcfg
    jm.backend = jax_common.Backend(
        module=JaxDLASeg(heads=heads, head_conv=HEAD_CONV, levels=LEVELS,
                         channels=CHANNELS, dtype=jnp.bfloat16),
        down_ratio=4, rotated_boxes=False, num_classes=NUM_CLASSES,
        num_keypoints=0, heads=heads, name="dla34")
    jm.centernet_loss = JaxLoss(**jcfg.model.backend.loss.params.to_dict())
    jm.optimizer_cfg = jcfg.optimizer.to_dict()
    jm.init_done()

    port = build_trainer(compose(OVERRIDES + PORT_ONLY), device="cpu")
    port.init_done()
    port.backend.module.load_state_dict(state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jm.state.params),
         "batch_stats": jax.tree.map(np.asarray, jm.state.batch_stats)}))

    steps, grad_dtypes = [], set()
    for seed in range(3):
        data = make_batch(seed)
        want = {k: float(v) for k, v in
                jm.step(to_jax(data), is_training=True)["stats"].items()}
        got = {k: float(v) for k, v in
               port.step(data, is_training=True)["stats"].items()}
        grad_dtypes |= {p.grad.dtype
                        for p in port.backend.module.parameters()}
        steps.append((got, want))
    return port, steps, grad_dtypes


@pytest.mark.parametrize("step", [0, 1, 2])
def test_bf16_loss_trajectory_matches_jax(trajectories, step):
    got, want = trajectories[1][step]
    assert set(got) == set(want)
    for k in ("hm_loss", "wh_loss", "off_loss", "total_loss"):
        # see the module docstring: from step 1 the two sides' bf16
        # gradient noise has taken different Adam steps
        assert got[k] == pytest.approx(want[k], rel=TOL if step == 0
                                       else 1e-1), k
    if step:
        assert got["total_loss"] != trajectories[1][step - 1][0]["total_loss"]


def test_bf16_step_keeps_f32_parameters_and_grads(trajectories):
    port, _, grad_dtypes = trajectories
    assert grad_dtypes == {torch.float32}
    net = port.backend.module
    assert {p.dtype for p in net.parameters()} == {torch.float32}
    assert {b.dtype for n, b in net.named_buffers()
            if not n.endswith("num_batches_tracked")} == {torch.float32}
    state = port.optimizer.state
    assert {v.dtype for s in state.values() for k, v in s.items()
            if k != "step"} == {torch.float32}
