"""EfficientNet-b0 through the trainers: three train steps of
``experiment=keypoints`` (with ``gpu=null`` and ``model.uda=null``: the
baseline trainer on b0 with skips and 5 keypoints) against the JAX trainer
from one bridged init, and the trainer's stochastic-depth generator.

Both trainers run without stochastic depth in the comparison (its masks
cannot match JAX's bits): the JAX trainer gets no ``dropout`` rng, the
port's backend no ``drop_generator``. The losses agree within 1e-3 over
three Adam steps at lr 1e-4 (``tests/test_torch_uda_twins.py`` says why),
at 128 px, where b0's deepest maps are 4 x 4: at 64 px they are 2 x 2 and
flax's one-pass BatchNorm variance (ROADMAP Queue C) parts JAX's losses
from the port's by 7.5e-3 at the third step.
"""

import jax
import numpy as np
import pytest
import torch

from centernet_uda_tpu import config as jax_config
from centernet_uda_tpu.losses.centernet import DetectionLoss as JaxLoss
from centernet_uda_tpu.models import common as jax_common
from centernet_uda_tpu.models import efficientnet as jax_effnet
from centernet_uda_tpu.uda.base import Model as JaxModel
from centernet_uda_torch.config import compose
from centernet_uda_torch.ops.gaussian import encode_targets
from centernet_uda_torch.train import build_trainer
from centernet_uda_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

BATCH, SIZE = 2, 128


def image(seed, size=SIZE):
    return np.random.RandomState(seed).randn(BATCH, size, size, 3).astype(
        np.float32)


def test_stochastic_depth_masks_follow_seed_and_step():
    """The trainer's generator gives the same heads for the same seed and
    step, other heads at another step, and nothing in eval mode."""
    def trainer(seed):
        t = build_trainer(compose(
            ["experiment=keypoints", "gpu=null", "model.uda=null",
             f"seed={seed}", "model.backend.params.num_classes=3"]),
            device="cpu")
        t.init_done()
        return t

    a, b, c = trainer(1), trainer(1), trainer(2)
    x = torch.from_numpy(image(6, 64).transpose(0, 3, 1, 2).copy())
    net_b = b.backend.module
    net_b.load_state_dict(a.backend.module.state_dict())
    c.backend.module.load_state_dict(a.backend.module.state_dict())

    def heads(t, step, train=True):
        t.global_step = step
        t._seed_drop_generator()
        t.backend.module.train(train)
        with torch.no_grad():
            return t.backend.module(x)["hm"]

    assert a.backend.module.drop_generator is a.drop_generator
    torch.testing.assert_close(heads(a, 5), heads(b, 5), rtol=0, atol=0)
    assert not torch.equal(heads(a, 5), heads(a, 6))
    assert not torch.equal(heads(a, 5), heads(c, 5))
    net_b.drop_generator = None
    assert not torch.equal(heads(a, 5), heads(b, 5))  # b without masks
    # eval mode: no masks (the running statistics made equal first, since
    # the train forwards above moved them)
    net_b.load_state_dict(a.backend.module.state_dict())
    net_b.drop_generator = a.drop_generator
    torch.testing.assert_close(heads(a, 5, False), heads(b, 5, False),
                               rtol=0, atol=0)
    torch.testing.assert_close(heads(a, 5, False), heads(a, 6, False),
                               rtol=0, atol=0)


# --- three train steps against the JAX trainer --------------------------------

MAX_DET, NUM_KPS = 20, 5
OVERRIDES = ["experiment=keypoints", "gpu=null", "model.uda=null",
             f"max_detections={MAX_DET}", f"batch_size={BATCH}",
             f"datasets.training.params.input_size=[{SIZE},{SIZE}]",
             "model.backend.params.num_classes=3",
             "optimizer.params.lr=0.0001"]


class JaxModelWithoutDropout(JaxModel):
    """The JAX trainer with its stochastic depth off (no ``dropout``
    rng), so its masks do not enter the comparison."""

    def _apply_backend(self, params, batch_stats, x, train, rng=None):
        return super()._apply_backend(params, batch_stats, x, train, None)


def make_batch(seed):
    rng = np.random.RandomState(seed)
    out = SIZE // 4
    per_image = []
    for _ in range(BATCH):
        n = rng.randint(2, 6)
        xy = rng.rand(n, 2) * out * 0.7
        boxes = np.concatenate([xy, xy + rng.rand(n, 2) * out * 0.3 + 1], 1)
        t = encode_targets(boxes, rng.randint(0, 3, n), out, out, 3, MAX_DET)
        valid = t["reg_mask"][:, None]
        t["kps"] = (rng.randn(MAX_DET, 2 * NUM_KPS) * 3).astype(
            np.float32) * valid
        t["kp_reg_mask"] = np.repeat(
            (rng.rand(MAX_DET, NUM_KPS) > 0.2) & (valid > 0), 2,
            -1).astype(np.uint8)
        per_image.append(t)
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
        jm = JaxModelWithoutDropout()
        jm.cfg = jcfg
        jm.backend = jax_effnet.build(3, "b0", num_keypoints=NUM_KPS,
                                      use_skip=True)
        jm.centernet_loss = JaxLoss(**jcfg.model.backend.loss.params.to_dict())
        jm.optimizer_cfg = jcfg.optimizer.to_dict()
        jm.init_done()
        port = build_trainer(compose(OVERRIDES), device="cpu")
        port.init_done()
        port.backend.module.drop_generator = None
        port.backend.module.load_state_dict(state_dict_from_jax(
            {"params": jax.tree.map(np.asarray, jm.state.params),
             "batch_stats": jax.tree.map(np.asarray, jm.state.batch_stats)},
            "efficientnet-b0"))
        previous = None
        for seed in range(3):
            data = make_batch(seed)
            want = jm.step(to_jax(data), is_training=True)["stats"]
            got = port.step(data, is_training=True)["stats"]
            assert set(got) == set(want)
            for k in ("hm_loss", "wh_loss", "off_loss", "kp_loss",
                      "total_loss"):
                assert float(got[k]) == pytest.approx(float(want[k]),
                                                      rel=1e-3), (seed, k)
            assert float(got["total_loss"]) != previous
            previous = float(got["total_loss"])
    finally:
        jax_common.set_bn_groups(old)
