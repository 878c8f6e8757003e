"""Checkpoints of the port's trainer (CPU, narrow DLA): the JAX package's
weights survive a save and a load; a resumed run is the uninterrupted run,
bit for bit; partial checkpoints load what fits and say what did not."""

import logging

import jax
import numpy as np
import pytest
import torch

from centernet_uda_tpu.models import common as jax_common
from centernet_uda_tpu.models.dla import DLASeg as JaxDLASeg
from centernet_uda_tpu.ops import dcn as jax_dcn
from centernet_uda_torch.config import compose
from centernet_uda_torch.ops.gaussian import encode_targets
from centernet_uda_torch.train import CONFIG_DIR, build_trainer
from centernet_uda_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

NARROW = ["model.backend.params.levels=[1,1,1,1,1,1]",
          "model.backend.params.channels=[4,8,8,16,16,32]",
          "model.backend.params.head_conv=8", "max_detections=10"]


def trainer(*overrides, num_classes=3):
    t = build_trainer(compose(
        ["experiment=baseline", f"model.backend.params.num_classes="
         f"{num_classes}"] + NARROW + list(overrides),
        config_dir=str(CONFIG_DIR)), device="cpu")
    t.init_done()
    return t


def batch(seed, size=64, num_classes=3):
    rng = np.random.RandomState(seed)
    out = size // 4
    ts = []
    for _ in range(2):
        xy = rng.rand(3, 2) * out * 0.7
        boxes = np.concatenate([xy, xy + 2 + rng.rand(3, 2) * 5], 1)
        ts.append(encode_targets(boxes, rng.randint(0, num_classes, 3), out,
                                 out, num_classes, 10))
    data = {k: np.stack([t[k] for t in ts]) for k in ts[0]}
    data["input"] = rng.randn(2, 3, size, size).astype(np.float32)
    data["id"] = np.arange(2)
    return data


def test_jax_weights_round_trip(tmp_path):
    """JAX DLA weights, bridged into the port, saved and loaded into a
    fresh model, give the JAX model's heads (tolerance of
    tests/test_torch_model.py)."""
    old = jax_dcn.get_pallas_default(), jax_common.get_bn_groups()
    jax_dcn.set_pallas_default(False)
    jax_common.set_bn_groups(1)
    try:
        module = JaxDLASeg(heads={"hm": 3, "wh": 2, "reg": 2},
                           levels=(1, 1, 1, 1, 1, 1),
                           channels=(4, 8, 8, 16, 16, 32), head_conv=8)
        x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
        # random JAX weights in the module's tree (shapes by tracing alone)
        rng = np.random.RandomState(3)

        def fill(path, leaf):
            name = getattr(path[-1], "key", "")
            if name == "var":
                return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
            return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)

        variables = jax.tree_util.tree_map_with_path(fill, jax.eval_shape(
            lambda x: module.init(jax.random.PRNGKey(0), x, train=False), x))
        want = jax.jit(lambda v, x: module.apply(v, x, train=False))(
            variables, x)
    finally:
        jax_dcn.set_pallas_default(old[0])
        jax_common.set_bn_groups(old[1])

    src = trainer("dcn_impl=xla")
    src.backend.module.load_state_dict(state_dict_from_jax(variables))
    src.save_model(tmp_path / "model.ckpt", 4)
    dst = trainer("dcn_impl=xla", "seed=9")
    assert dst.load_model(tmp_path / "model.ckpt") == 1
    net = dst.backend.module.eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for k, ref in want.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(
            got[k].numpy().transpose(0, 2, 3, 1), ref, rtol=1e-3,
            atol=1e-4 * max(1.0, np.abs(ref).max()), err_msg=k)


def test_resume_equals_uninterrupted(tmp_path, caplog):
    """2 steps, a checkpoint with the optimizer, a resume into a model
    initialised from another seed, 1 step: bit for bit the 3-step run."""
    data = [batch(i) for i in range(3)]
    straight = trainer()
    for d in data:
        straight.step(d)

    first = trainer()
    for d in data[:2]:
        first.step(d)
    first.save_model(tmp_path / "last.ckpt", 2, with_optimizer=True)
    resumed = trainer("seed=7")
    with caplog.at_level(logging.INFO):
        assert resumed.load_model(tmp_path / "last.ckpt", resume=True) == 3
    assert "restore optimizer state at epoch 2" in caplog.text
    assert resumed.epoch == 2
    resumed.step(data[2])

    want = straight.backend.module.state_dict()
    got = resumed.backend.module.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    want_opt = straight.optimizer.state_dict()["state"]
    got_opt = resumed.optimizer.state_dict()["state"]
    assert set(got_opt) == set(want_opt)
    for i in want_opt:
        for name, value in want_opt[i].items():
            assert torch.equal(got_opt[i][name], value), (i, name)


def test_partial_checkpoints(tmp_path, caplog):
    """A shape-mismatched entry is skipped and a missing one kept, each
    with a warning; ``pretrained`` loads weights only and resets the
    epoch; a missing file is a warning."""
    src = trainer()
    src.step(batch(0))
    src.save_model(tmp_path / "m.ckpt", 5, with_optimizer=True)
    saved = torch.load(tmp_path / "m.ckpt", weights_only=True)
    assert set(saved) == {"epoch", "state_dict", "optimizer"}
    assert saved["epoch"] == 5
    dropped = "hm.0.weight"
    del saved["state_dict"][dropped]
    torch.save(saved, tmp_path / "partial.ckpt")

    dst = trainer("seed=3", num_classes=4)
    fresh = {k: v.clone() for k, v in dst.backend.module.state_dict().items()}
    with caplog.at_level(logging.WARNING):
        assert dst.load_model(tmp_path / "partial.ckpt") == 1
    assert dst.epoch == 0
    assert not dst.optimizer.state  # pretrained: no optimizer state
    assert f"no parameter {dropped} available" in caplog.text
    assert "skip parameter hm.2.weight because of shape mismatch" in \
        caplog.text
    got = dst.backend.module.state_dict()
    src_state = src.backend.module.state_dict()
    for k, v in got.items():
        if k in (dropped, "hm.2.weight", "hm.2.bias"):
            assert torch.equal(v, fresh[k]), k
        else:
            assert torch.equal(v, src_state[k]), k

    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert dst.load_model(tmp_path / "absent.ckpt", resume=True) == 1
    assert "does not exist" in caplog.text


@pytest.mark.parametrize("with_optimizer", [False, True])
def test_checkpoint_is_written_atomically(tmp_path, with_optimizer):
    t = trainer()
    t.save_model(tmp_path / "model_last.ckpt", 1, with_optimizer)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["model_last.ckpt"]
    data = torch.load(tmp_path / "model_last.ckpt", weights_only=True)
    assert ("optimizer" in data) == with_optimizer
