"""The port's trainer on its own (CPU, narrow DLA): the loud degrade to the
exact DCN op at the offset clamp, the entry points' refusals, and the
data-parallel settings on one device (the JAX package's warning, BatchNorm
groups)."""

import logging

import numpy as np
import pytest
import torch

from centernet_uda_torch.config import compose
from centernet_uda_torch.models.common import BatchNorm2d
from centernet_uda_torch.ops.dcn import DCN, PALLAS_MAX_SHIFT, kernel_route
from centernet_uda_torch.ops.gaussian import encode_targets
from centernet_uda_torch.train import build_trainer
from centernet_uda_torch.uda.base import Model

torch.set_num_threads(2)

NARROW = ["model.backend.params.levels=[1,1,1,1,1,1]",
          "model.backend.params.channels=[4,8,8,16,16,32]",
          "model.backend.params.head_conv=8",
          "model.backend.params.num_classes=2", "max_detections=10"]


def batch(seed=0, size=64):
    rng = np.random.RandomState(seed)
    out = size // 4
    ts = [encode_targets(np.array([[2.0, 3.0, 9.0, 11.0]]), [1], out, out, 2,
                         10) for _ in range(2)]
    data = {k: np.stack([t[k] for t in ts]) for k in ts[0]}
    data["input"] = rng.randn(2, 3, size, size).astype(np.float32)
    data["id"] = np.arange(2)
    return data


def test_degrade_to_exact_op_at_the_clamp(caplog):
    """On the kernel path (here its CPU twin, ``dcn_impl: cuda``) the step
    reports max|dy|; at the clamp every DCN switches to the exact op, with
    an error log, and the monitor goes quiet."""
    trainer = build_trainer(compose(["experiment=baseline", "dcn_impl=cuda"]
                                    + NARROW), device="cpu")
    trainer.init_done()
    dcns = [m for m in trainer.backend.module.modules()
            if isinstance(m, DCN)]
    assert len(dcns) == 16
    stats = trainer.step(batch(), is_training=True)["stats"]
    assert float(stats["dcn_max_abs_dy"]) == 0.0  # zero-initialised offsets
    assert not trainer.maybe_degrade_dcn(PALLAS_MAX_SHIFT - 0.5)

    with torch.no_grad():
        dcns[3].conv_offset_mask.bias[2] = PALLAS_MAX_SHIFT + 1.0  # a dy
    stats = trainer.step(batch(1), is_training=False)["stats"]
    value = float(stats["dcn_max_abs_dy"])
    assert value >= PALLAS_MAX_SHIFT
    with caplog.at_level(logging.ERROR):
        assert trainer.maybe_degrade_dcn(value)
    assert "exact DCN op" in caplog.text
    assert all(m.impl == "xla" for m in dcns)
    assert "dcn_max_abs_dy" not in trainer.step(batch(2), True)["stats"]
    assert not trainer.maybe_degrade_dcn(value)  # once


@pytest.mark.parametrize("override,match", [
    ("precision=float16", "precision"),
])
def test_unported_settings_raise(override, match):
    cfg = compose(["experiment=baseline", override] + NARROW)
    with pytest.raises(NotImplementedError, match=match):
        build_trainer(cfg, device="cpu")


@pytest.mark.parametrize("overrides,warning,groups", [
    (["gpu=[0,1]"], "requested 2-way data parallelism but only 1 device",
     1),
    (["mesh={data: 2}"], "requested 2-way data parallelism but only 1 "
     "device", 1),
    (["mesh={data: 1}", "batch_size=3"], None, 1),
    (["bn_sync=2"], None, 2),
    (["bn_sync=replica"], None, 1),
    (["bn_sync=4", "gpu=[0,1]"], "running single-device", 4),
])
def test_data_parallel_settings_on_one_device(caplog, overrides, warning,
                                              groups):
    """Without a process group, a config asking for more devices than the
    CPU's one warns as the JAX package does and builds for one device; the
    BatchNorm layers take ``bn_sync``'s groups (``replica`` on one device is
    the whole batch)."""
    cfg = compose(["experiment=baseline"] + overrides + NARROW)
    with caplog.at_level(logging.WARNING, logger="uda"):
        trainer = build_trainer(cfg, device="cpu")
    if warning is None:
        assert "single-device" not in caplog.text
    else:
        assert warning in caplog.text and "single-device" in caplog.text
    bns = [m for m in trainer.backend.module.modules()
           if isinstance(m, BatchNorm2d)]
    assert bns and {m.groups for m in bns} == {groups}
    trainer.init_done()
    stats = trainer.step(batch(), is_training=True)["stats"]
    assert all(np.isfinite(float(v)) for v in stats.values())


def test_bn_sync_rejects_other_words():
    cfg = compose(["experiment=baseline", "bn_sync=device"] + NARROW)
    with pytest.raises(ValueError, match="bn_sync"):
        build_trainer(cfg, device="cpu")


def test_bfloat16_trainer_builds_and_steps():
    """``precision=bfloat16``: every layer computes in bf16 (each DCN on the
    route the JAX package takes: fused at 8 <= W <= 256, select below 8
    columns, which this 64 px input reaches at W = 4 and 2; bf16 out on
    both), the parameters and their gradients stay f32, the heads come out
    f32, and TF32 stays off."""
    trainer = build_trainer(compose(["experiment=baseline",
                                     "precision=bfloat16", "dcn_impl=cuda"]
                                    + NARROW), device="cpu")
    trainer.init_done()
    net = trainer.backend.module
    dcns = [m for m in net.modules() if isinstance(m, DCN)]
    assert {m.compute_dtype for m in dcns} == {torch.bfloat16}
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    routes = {}

    def record(mod, args, out):
        x = args[0]
        routes[tuple(x.shape[2:])] = (kernel_route(
            tuple(x.shape), torch.bfloat16, tuple(mod.weight.shape)),
            out.dtype)

    hooks = [m.register_forward_hook(record) for m in dcns]
    stats = trainer.step(batch(), is_training=True)["stats"]
    for h in hooks:
        h.remove()
    assert routes == {(16, 16): ("fused", torch.bfloat16),
                      (8, 8): ("fused", torch.bfloat16),
                      (4, 4): ("select", torch.bfloat16),
                      (2, 2): ("select", torch.bfloat16)}
    assert all(np.isfinite(float(v)) for v in stats.values())
    assert float(stats["dcn_max_abs_dy"]) == 0.0  # zero-initialised offsets
    assert {p.dtype for p in net.parameters()} == {torch.float32}
    assert {p.grad.dtype for p in net.parameters()} == {torch.float32}
    out = trainer.step(batch(1), is_training=False)
    assert {v.dtype for v in out["source_domain"].values()} == {
        torch.float32}


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = compose(["experiment=baseline"] + NARROW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_trainer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model()
    assert build_trainer(cfg, device="cpu").device == torch.device("cpu")
