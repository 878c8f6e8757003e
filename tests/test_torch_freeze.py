"""``freeze_base`` in the port against the JAX package (CPU, float32);
``tests/test_torch_pretrained.py`` holds the backend's ``pretrained``.

``freeze_base`` on a narrow DLA, ResNet-18 and EfficientNet-b0 at weight
decay 0: two Adam steps (lr 1e-4) from one bridged init leave every trunk
parameter bitwise unchanged on both sides and out of the port's optimizer,
move every other parameter on both sides, give the same losses within
1e-3 and move the trunk's BatchNorm statistics alike (within 1e-4). (The
other parameters themselves are not compared element by element: JAX's
train-mode gradients carry its one-pass BatchNorm variance noise, see
``tests/test_torch_resnet.py``, and Adam turns a noisy gradient that is
zero in exact arithmetic into a +-lr step.)

At weight decay 1e-4 the port's trunk still stays bitwise unchanged while
JAX's moves (every leaf that is not all zeros): the JAX package zeroes the frozen gradient before
``add_decayed_weights`` (``centernet_uda_tpu/utils/optim.py:84-88``), so
the decay term still updates the trunk; the port leaves the trunk out of
the optimizer, as the reference does (ROADMAP Queue C). The JAX trainer
runs without a ``dropout`` rng, so EfficientNet's stochastic depth stays
off on both sides.
"""

import jax
import numpy as np
import pytest
import torch

from centernet_uda_tpu import config as jax_config
from centernet_uda_tpu.losses.centernet import DetectionLoss as JaxLoss
from centernet_uda_tpu.models import common as jax_common
from centernet_uda_tpu.models import dla as jax_dla
from centernet_uda_tpu.models import efficientnet as jax_effnet
from centernet_uda_tpu.models import resnet as jax_resnet
from centernet_uda_tpu.ops import dcn as jax_dcn
from centernet_uda_tpu.uda.base import Model as JaxModel
from centernet_uda_torch.config import compose
from centernet_uda_torch.ops.gaussian import encode_targets
from centernet_uda_torch.train import build_trainer
from centernet_uda_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

NUM_CLASSES, BATCH, SIZE, MAX_DET = 3, 2, 64, 20
LEVELS, CHANNELS, HEAD_CONV = [1, 1, 1, 1, 1, 1], [4, 8, 8, 16, 16, 32], 8
NARROW_DLA = [f"model.backend.params.levels={LEVELS}",
              f"model.backend.params.channels={CHANNELS}",
              f"model.backend.params.head_conv={HEAD_CONV}"]


class JaxModelWithoutDropout(JaxModel):
    """The JAX trainer without a ``dropout`` rng (no stochastic depth)."""

    def _apply_backend(self, params, batch_stats, x, train, rng=None):
        return super()._apply_backend(params, batch_stats, x, train, None)


def jax_backend(kind, freeze):
    heads = jax_common.make_heads_dict(NUM_CLASSES, 0, False)
    if kind == "dla":
        return jax_common.Backend(
            module=jax_dla.DLASeg(heads=heads, head_conv=HEAD_CONV,
                                  levels=LEVELS, channels=CHANNELS),
            down_ratio=4, rotated_boxes=False, num_classes=NUM_CLASSES,
            num_keypoints=0, heads=heads, name="dla34",
            extra={"freeze_base": freeze})
    if kind == "resnet18":
        return jax_resnet.build(18, NUM_CLASSES, freeze_base=freeze)
    return jax_effnet.build(NUM_CLASSES, "b0", use_skip=True,
                            freeze_base=freeze)


EXPERIMENTS = {"dla": ["experiment=baseline", "dcn_impl=xla"] + NARROW_DLA,
               "resnet18": ["experiment=baseline_resnet18"],
               "efficientnet-b0": ["experiment=keypoints", "gpu=null",
                                   "model.uda=null",
                                   "model.backend.params.num_keypoints=0",
                                   "model.backend.loss.params.kp_weight=null",
                                   "model.backend.loss.params.kp_indices=null"
                                   ]}


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


def run_frozen(kind, weight_decay):
    """Two steps on both sides; returns the JAX variables before and
    after, the port's state dict before, the port's trainer and the losses
    of both sides per step."""
    old = jax_dcn.get_pallas_default(), jax_common.get_bn_groups()
    jax_dcn.set_pallas_default("xla")
    jax_common.set_bn_groups(1)
    try:
        overrides = EXPERIMENTS[kind] + [
            f"max_detections={MAX_DET}", f"batch_size={BATCH}",
            f"datasets.training.params.input_size=[{SIZE},{SIZE}]",
            f"model.backend.params.num_classes={NUM_CLASSES}",
            "model.backend.params.freeze_base=true",
            "optimizer.params.lr=0.0001",
            f"optimizer.params.weight_decay={weight_decay}"]
        jcfg = jax_config.compose(overrides)
        jm = JaxModelWithoutDropout()
        jm.cfg = jcfg
        jm.backend = jax_backend(kind, True)
        jm.centernet_loss = JaxLoss(**jcfg.model.backend.loss.params.to_dict())
        jm.optimizer_cfg = jcfg.optimizer.to_dict()
        jm.init_done()
        before = {"params": jax.tree.map(np.asarray, jm.state.params),
                  "batch_stats": jax.tree.map(np.asarray,
                                              jm.state.batch_stats)}
        port = build_trainer(compose(overrides), device="cpu")
        port.init_done()
        net = port.backend.module
        if hasattr(net, "drop_generator"):
            net.drop_generator = None
        net.load_state_dict(state_dict_from_jax(before, kind))
        port_before = {k: v.clone() for k, v in net.state_dict().items()}
        losses = []
        for seed in range(2):
            data = make_batch(seed)
            want = jm.step(to_jax(data), is_training=True)["stats"]
            got = port.step(data, is_training=True)["stats"]
            losses.append((float(got["total_loss"]),
                           float(want["total_loss"])))
        after = {"params": jax.tree.map(np.asarray, jm.state.params),
                 "batch_stats": jax.tree.map(np.asarray,
                                             jm.state.batch_stats)}
        return before, after, port_before, port, losses
    finally:
        jax_dcn.set_pallas_default(old[0])
        jax_common.set_bn_groups(old[1])


def trunk_params(net):
    return {k for k, _ in net.named_parameters() if k.startswith("base.")}


@pytest.mark.parametrize("kind", list(EXPERIMENTS))
def test_freeze_base_matches_jax_without_weight_decay(kind):
    before, after, port_before, port, losses = run_frozen(kind, 0.0)
    for got, want in losses:
        assert got == pytest.approx(want, rel=1e-3)
    net = port.backend.module
    trunk = trunk_params(net)
    assert trunk and all(not p.requires_grad for k, p in
                         net.named_parameters() if k in trunk)
    in_optimizer = {id(p) for g in port.optimizer.param_groups
                    for p in g["params"]}
    assert all((id(p) in in_optimizer) == (k not in trunk)
               for k, p in net.named_parameters())
    # JAX: the trunk bitwise unchanged, every other parameter moved
    np.testing.assert_equal(after["params"]["base"],
                            before["params"]["base"])
    want = state_dict_from_jax(after, kind)
    start = state_dict_from_jax(before, kind)
    now = net.state_dict()
    moved_stats = 0
    for key, _ in net.named_parameters():
        if key in trunk:
            assert torch.equal(now[key], port_before[key]), key
        else:
            assert not torch.equal(now[key], port_before[key]), key
            assert not torch.equal(want[key], start[key]), key
    for key, value in now.items():
        if key.startswith("base.") and key.endswith(("running_mean",
                                                     "running_var")):
            moved_stats += not torch.equal(value, port_before[key])
            np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=key)
    assert moved_stats > 0


@pytest.mark.parametrize("kind", ["resnet18"])
def test_freeze_base_with_weight_decay_differs_from_jax(kind):
    """The known difference: with weight decay the JAX package's frozen
    trunk moves, the port's does not."""
    before, after, port_before, port, _ = run_frozen(kind, 1e-4)
    net = port.backend.module
    for key in trunk_params(net):
        assert torch.equal(net.state_dict()[key], port_before[key]), key
    # decay moves every leaf but the all-zero ones (the BN shifts at init)
    pairs = zip(jax.tree.leaves(after["params"]["base"]),
                jax.tree.leaves(before["params"]["base"]))
    moved = [(not np.array_equal(a, b), bool(np.any(b))) for a, b in pairs]
    assert all(m == nonzero for m, nonzero in moved)
    assert sum(m for m, _ in moved) >= 40
