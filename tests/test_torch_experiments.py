"""Every shipped experiment through the port's ``build_trainer`` on the CPU
at full width: it builds, and takes one train step on a seeded batch of
one image (64 px; 128 px for ADVENT, whose discriminator needs a 32 x 32
heatmap) with finite losses, the step moving the weights. Experiments on
two devices (``keypoints`` as shipped, ``adversarial_entropy_minimization_
dla``, both ``gpu: [0, 1]``) warn as the JAX package does and build for
the CPU's one device.
"""

import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from centernet_uda_torch.config import compose
from centernet_uda_torch.ops.gaussian import encode_targets
from centernet_uda_torch.train import build_trainer

torch.set_num_threads(2)

EXPERIMENTS = sorted(p.stem for p in (
    Path(__file__).resolve().parents[1] / "configs" / "experiment").glob(
        "*.yaml"))
MULTI_DEVICE = {"adversarial_entropy_minimization_dla", "keypoints"}
MAX_DET = 16


def batch_for(trainer, size):
    """One image with three objects, targets for the backend's heads (a
    rotated ``wh``, keypoints) and a target domain for UDA methods."""
    backend = trainer.backend
    rng = np.random.RandomState(0)
    out = size // backend.down_ratio
    xy = rng.rand(3, 2) * out * 0.6
    boxes = np.concatenate([xy, xy + rng.rand(3, 2) * out * 0.3 + 2], 1)
    t = encode_targets(boxes, rng.randint(0, backend.num_classes, 3), out,
                       out, backend.num_classes, MAX_DET)
    valid = t["reg_mask"][:, None].astype(np.float32)
    if backend.rotated_boxes:
        t["wh"] = np.concatenate(
            [t["wh"], rng.uniform(-90, 90, (MAX_DET, 1)) * valid],
            1).astype(np.float32)
    if backend.num_keypoints:
        p = backend.num_keypoints
        t["kps"] = (rng.randn(MAX_DET, 2 * p) * valid).astype(np.float32)
        t["kp_reg_mask"] = np.repeat(valid > 0, 2 * p, 1).astype(np.uint8)
    data = {k: v[None] for k, v in t.items()}
    data["input"] = rng.randn(1, 3, size, size).astype(np.float32)
    data["target_domain_input"] = rng.randn(1, 3, size, size).astype(
        np.float32)
    return data


@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_experiment_builds_and_steps(experiment, caplog):
    overrides = [f"experiment={experiment}", f"max_detections={MAX_DET}"]
    with caplog.at_level(logging.WARNING, logger="uda"):
        trainer = build_trainer(compose(overrides), device="cpu")
    warned = ("requested 2-way data parallelism but only 1 device(s) "
              "available; running single-device") in caplog.text
    assert warned == (experiment in MULTI_DEVICE)
    trainer.init_done()
    size = 128 if experiment.startswith("adversarial") else 64
    before = [p.detach().clone() for p in trainer.optimizer.param_groups[0][
        "params"][-4:]]
    stats = trainer.step(batch_for(trainer, size), is_training=True)["stats"]
    assert all(np.isfinite(float(v)) for v in stats.values()), stats
    after = trainer.optimizer.param_groups[0]["params"][-4:]
    assert any(not torch.equal(a, b) for a, b in zip(after, before))
