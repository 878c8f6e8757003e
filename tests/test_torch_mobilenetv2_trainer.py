"""MobileNetV2 with its DCN neck through the port's ``build_trainer``
against the JAX package's ``Model`` on the same config, from one bridged
init (CPU, float32).

``experiment=baseline_mobilenet_v2`` with ``use_dcn=true`` (full width,
skips; Adam with coupled weight decay, ``DetectionLoss``) at 64 px, batch
2, with ``dcn_impl: xla`` on both sides: three train steps on three seeded
batches give the same losses, and an eval step with ``get_detections``
runs. A second trainer on the kernel path (``dcn_impl: cuda``: on the CPU,
the twins of the select and lanes kernels) takes one step from the same
init.

Tolerance: the losses agree to 2e-3 relative. In train mode JAX's
one-pass BatchNorm variance carries f32 noise that reaches the heads at
5e-4 of their scale (``tests/test_torch_mobilenetv2.py``), and Adam's
first steps turn gradient noise into steps of about lr; at the
experiment's lr (5e-5) the losses of steps 1 and 2 stay within that. The
kernel path's step-0 losses are held at 5e-2 of the exact path's, the
bound of the Pallas kernels' own tests.
"""

import jax
import numpy as np
import pytest
import torch

from centernet_uda_tpu import config as jax_config
from centernet_uda_tpu.losses.centernet import DetectionLoss as JaxLoss
from centernet_uda_tpu.models import common as jax_common
from centernet_uda_tpu.models import mobilenetv2 as jax_mnv2
from centernet_uda_tpu.ops import dcn as jax_dcn
from centernet_uda_tpu.uda.base import Model as JaxModel
from centernet_uda_torch.config import compose
from centernet_uda_torch.ops import dcn_cuda
from centernet_uda_torch.ops.dcn import DCN
from centernet_uda_torch.ops.gaussian import encode_targets
from centernet_uda_torch.train import build_trainer
from centernet_uda_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

NUM_CLASSES, SIZE, BATCH, MAX_DET = 3, 64, 2, 20
OVERRIDES = [
    "experiment=baseline_mobilenet_v2", "model.backend.params.use_dcn=true",
    "dcn_impl=xla", f"max_detections={MAX_DET}", f"batch_size={BATCH}",
    f"datasets.training.params.input_size=[{SIZE},{SIZE}]",
    f"model.backend.params.num_classes={NUM_CLASSES}",
]
LOSSES = ("hm_loss", "wh_loss", "off_loss", "total_loss")


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


def port_trainer(overrides, variables):
    port = build_trainer(compose(overrides), device="cpu")
    port.init_done()
    port.backend.module.load_state_dict(state_dict_from_jax(
        variables, "mobilenetv2"))
    return port


@pytest.fixture(scope="module")
def trainers():
    old = jax_dcn.get_pallas_default(), jax_common.get_bn_groups()
    jax_dcn.set_pallas_default("xla")
    jax_common.set_bn_groups(1)

    jcfg = jax_config.compose(OVERRIDES)
    jm = JaxModel()
    jm.cfg = jcfg
    jm.backend = jax_mnv2.build(NUM_CLASSES, use_dcn=True, use_skip=True)
    jm.centernet_loss = JaxLoss(**jcfg.model.backend.loss.params.to_dict())
    jm.optimizer_cfg = jcfg.optimizer.to_dict()
    jm.init_done()
    init = {"params": jax.tree.map(np.asarray, jm.state.params),
            "batch_stats": jax.tree.map(np.asarray, jm.state.batch_stats)}
    port = port_trainer(OVERRIDES, init)

    steps = []
    for seed in range(3):
        data = make_batch(seed)
        want = {k: float(v) for k, v in
                jm.step(to_jax(data), is_training=True)["stats"].items()}
        got = {k: float(v) for k, v in
               port.step(data, is_training=True)["stats"].items()}
        steps.append((got, want))
    yield jm, port, steps, init
    jax_dcn.set_pallas_default(old[0])
    jax_common.set_bn_groups(old[1])


@pytest.mark.parametrize("step", [0, 1, 2])
def test_loss_trajectory_matches_jax(trainers, step):
    got, want = trainers[2][step]
    assert set(got) == set(want)
    for k in LOSSES:
        assert got[k] == pytest.approx(want[k], rel=2e-3), k
    if step:
        assert got["total_loss"] != trainers[2][step - 1][0]["total_loss"]


def test_eval_step_and_detections(trainers):
    _, port, _, _ = trainers
    data = make_batch(7)
    out = port.step(data, is_training=False)
    dets = port.get_detections(out, data)
    assert dets["pred_boxes"].shape == (BATCH, MAX_DET, 4)
    assert np.isfinite(dets["pred_boxes"]).all()
    assert all(np.isfinite(float(v)) for v in out["stats"].values())


def test_kernel_path_step_matches_exact(trainers):
    """The kernel path from the same init: select twins at W = 2 and 4,
    lanes twin at W = 8, no launch on the CPU, and the clamp monitor read
    (0: the offset convs start at zero)."""
    _, _, steps, init = trainers
    port = port_trainer([o if o != "dcn_impl=xla" else "dcn_impl=cuda"
                         for o in OVERRIDES], init)
    assert {m.impl for m in port.backend.module.modules()
            if isinstance(m, DCN)} == {"cuda"}
    dcn_cuda.reset_launches()
    got = {k: float(v) for k, v in
           port.step(make_batch(0), is_training=True)["stats"].items()}
    assert all(v == 0 for v in dcn_cuda.LAUNCHES.values())
    assert got["dcn_max_abs_dy"] == 0.0
    for k in LOSSES:
        assert got[k] == pytest.approx(steps[0][0][k], rel=5e-2), k
