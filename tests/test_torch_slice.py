"""The slice end to end: the port's ``build_trainer`` against the JAX
package's ``Model`` on the same config, from one bridged init.

``experiment=baseline`` (Adam with coupled weight decay, MultiStepLR,
``DetectionLoss``) on a narrow DLA at 64 px, batch 2, with ``dcn_impl: xla``
on both sides. Three train steps on three distinct seeded batches must give
the same losses, then an eval step and ``get_detections`` the same
detections. The JAX side compiles once, in a module-scoped fixture.
"""

import jax
import numpy as np
import pytest
import torch

from centernet_uda_tpu import config as jax_config
from centernet_uda_tpu.losses.centernet import DetectionLoss as JaxLoss
from centernet_uda_tpu.models import common as jax_common
from centernet_uda_tpu.models.dla import DLASeg as JaxDLASeg
from centernet_uda_tpu.ops import dcn as jax_dcn
from centernet_uda_tpu.uda.base import Model as JaxModel
from centernet_uda_tpu.utils import optim as jax_optim
from centernet_uda_torch.config import compose
from centernet_uda_torch.ops.gaussian import encode_targets
from centernet_uda_torch.train import build_trainer
from centernet_uda_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

NUM_CLASSES, SIZE, BATCH, MAX_DET = 3, 64, 2, 20
LEVELS, CHANNELS, HEAD_CONV = [1, 1, 1, 1, 1, 1], [4, 8, 8, 16, 16, 32], 8
OVERRIDES = [
    "experiment=baseline", "dcn_impl=xla", f"max_detections={MAX_DET}",
    f"batch_size={BATCH}",
    f"datasets.training.params.input_size=[{SIZE},{SIZE}]",
    f"model.backend.params.num_classes={NUM_CLASSES}",
    # a larger lr than the baseline's 5e-5 so three steps move the losses
    "optimizer.params.lr=0.001",
]
PORT_ONLY = [f"model.backend.params.levels={LEVELS}",
             f"model.backend.params.channels={CHANNELS}",
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
def trainers():
    old = jax_dcn.get_pallas_default(), jax_common.get_bn_groups()
    jax_dcn.set_pallas_default("xla")
    jax_common.set_bn_groups(1)

    jcfg = jax_config.compose(OVERRIDES)
    heads = jax_common.make_heads_dict(NUM_CLASSES, 0, False)
    jm = JaxModel()
    jm.cfg = jcfg
    jm.backend = jax_common.Backend(
        module=JaxDLASeg(heads=heads, head_conv=HEAD_CONV, levels=LEVELS,
                         channels=CHANNELS),
        down_ratio=4, rotated_boxes=False, num_classes=NUM_CLASSES,
        num_keypoints=0, heads=heads, name="dla34")
    jm.centernet_loss = JaxLoss(**jcfg.model.backend.loss.params.to_dict())
    jm.optimizer_cfg = jcfg.optimizer.to_dict()
    sched = jcfg.optimizer.scheduler
    jm.scheduler = jax_optim.make_scheduler(sched.name, sched.params)
    jm.init_done()

    port = build_trainer(compose(OVERRIDES + PORT_ONLY), device="cpu")
    port.init_done()
    port.backend.module.load_state_dict(state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jm.state.params),
         "batch_stats": jax.tree.map(np.asarray, jm.state.batch_stats)}))

    steps = []
    for seed in range(3):
        data = make_batch(seed)
        want = {k: float(v) for k, v in
                jm.step(to_jax(data), is_training=True)["stats"].items()}
        got = {k: float(v) for k, v in
               port.step(data, is_training=True)["stats"].items()}
        steps.append((got, want))
    yield jm, port, steps
    jax_dcn.set_pallas_default(old[0])
    jax_common.set_bn_groups(old[1])


@pytest.mark.parametrize("step", [0, 1, 2])
def test_loss_trajectory_matches_jax(trainers, step):
    got, want = trainers[2][step]
    assert set(got) == set(want)
    for k in ("hm_loss", "wh_loss", "off_loss", "total_loss"):
        # f32 on both sides; Adam's first steps amplify gradient noise, so
        # 1e-3 relative after three steps
        assert got[k] == pytest.approx(want[k], rel=1e-3), k
    if step:
        assert got["total_loss"] != trainers[2][step - 1][0]["total_loss"]


def test_detections_match_jax(trainers):
    """Eval step and decode on the same trained weights: the JAX state after
    the three steps is bridged into the port first. (Without that, eval
    outputs differ at 1e-3: Adam turns the f32 noise of gradients that are
    zero in exact arithmetic, those of biases feeding a train-mode BN, into
    +-lr steps, which eval-mode BN passes through.)"""
    jm, port, _ = trainers
    port.backend.module.load_state_dict(state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jm.state.params),
         "batch_stats": jax.tree.map(np.asarray, jm.state.batch_stats)}))
    data = make_batch(7)
    jout = jm.step(to_jax(data), is_training=False)
    pout = port.step(data, is_training=False)
    for k in ("hm_loss", "wh_loss", "off_loss", "total_loss"):
        assert float(pout["stats"][k]) == pytest.approx(
            float(jout["stats"][k]), rel=1e-3), k
    want = jm.get_detections(jout, to_jax(data))
    got = port.get_detections(pout, data)
    scores = want["pred_scores"]
    assert scores.shape == (BATCH, MAX_DET)
    # distinct scores: the top-k order is defined on both sides
    assert all(len(np.unique(s)) == MAX_DET for s in scores)
    np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
    np.testing.assert_allclose(got["pred_scores"], scores, rtol=1e-3,
                               atol=1e-6)
    # boxes in input pixels (x down_ratio); sub-pixel f32 noise
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"],
                               atol=1e-2)
    for a, b in zip(got["gt_boxes"], want["gt_boxes"]):
        np.testing.assert_allclose(a, b)
    for key in ("gt_classes", "gt_ids", "gt_areas"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a, b)


def test_epoch_end_schedule_matches_jax(trainers):
    """MultiStepLR [30, 60] x 0.1, written into the optimizer by
    ``epoch_end`` on both sides."""
    jm, port, _ = trainers
    seen = {}
    for _ in range(61):
        jm.epoch_end()
        port.epoch_end()
        seen[port.epoch] = (optim_lr(port), jax_optim.get_learning_rate(
            jm.state.opt_state))
    for epoch, lr in ((29, 1e-3), (30, 1e-4), (59, 1e-4), (60, 1e-5),
                      (61, 1e-5)):
        assert seen[epoch][0] == pytest.approx(lr)
        assert seen[epoch][1] == pytest.approx(lr)


def optim_lr(trainer):
    return trainer.optimizer.param_groups[0]["lr"]
