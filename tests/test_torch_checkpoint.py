"""Checkpoints of the port's trainer (CPU, narrow DLA): the JAX package's
weights survive a save and a load; a resumed run is the uninterrupted run,
bit for bit; partial checkpoints load what fits and say what did not; keys
with DataParallel's ``module.`` prefix load; the JAX package's own
checkpoint loads, evaluates and exports in a process without JAX; the
TensorBoard logger writes without tensorboardX."""

import ast
import json
import logging
import os
import re
from pathlib import Path

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

ROOT = Path(__file__).resolve().parents[1]

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


def test_module_prefixed_checkpoint_loads_every_weight(tmp_path, caplog):
    """A checkpoint whose keys carry DataParallel's ``module.`` prefix (the
    JAX-bridged weights saved that way) loads every weight, from a zip and
    from torch's legacy format alike: the heads are the unprefixed
    checkpoint's (tolerance of the round trip above)."""
    src = trainer("dcn_impl=xla")
    state = {f"module.{k}": v for k, v in
             src.backend.module.state_dict().items()}
    torch.save({"epoch": 2, "state_dict": state}, tmp_path / "dp.ckpt")
    torch.save(state, tmp_path / "bare.pth")
    # torch's legacy format (before torch 1.6), as the reference's .pth are
    torch.save({"epoch": 2, "state_dict": state}, tmp_path / "legacy.ckpt",
               _use_new_zipfile_serialization=False)
    torch.save(state, tmp_path / "legacy.pth",
               _use_new_zipfile_serialization=False)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 64, 64)
                         .astype(np.float32))
    with torch.no_grad():
        want = src.backend.module.eval()(x)
    for name in ("dp.ckpt", "bare.pth", "legacy.ckpt", "legacy.pth"):
        dst = trainer("dcn_impl=xla", "seed=9")
        caplog.clear()
        with caplog.at_level(logging.INFO):
            assert dst.load_model(tmp_path / name) == 1
        n = len(state)
        assert f"restored {n} of {n} weights" in caplog.text, name
        assert "no parameter" not in caplog.text, name
        with torch.no_grad():
            got = dst.backend.module.eval()(x)
        for k, ref in want.items():
            np.testing.assert_allclose(
                got[k].numpy(), ref.numpy(), rtol=1e-3,
                atol=1e-4 * max(1.0, float(ref.abs().max())), err_msg=k)


ADVENT_SIZE = 128

# runs in a process with JAX, flax and optax blocked: main() with the JAX
# checkpoint as ``pretrained`` on a test split, the trainer's load_model,
# and the export CLI on it; saves the heads of both and the discriminator
_NO_JAX_CHECKPOINT_RUN = """
import glob, json, os, shutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "centernet_uda_tpu"):
    sys.modules[name] = None
import logging
import numpy as np
import torch
from centernet_uda_torch import export, train
from centernet_uda_torch.config import compose
args = json.loads(sys.argv[1])
records = []
handler = logging.Handler()
handler.emit = records.append
logging.getLogger("centernet_uda_torch.utils.checkpoint").addHandler(handler)
phases = []
cwd = os.getcwd()
train.main(args["main"], device="cpu", phases=phases)
os.chdir(cwd)  # main() runs in its run dir
assert [p["tag"] for p in phases] == ["test"], phases
x = torch.from_numpy(np.load(args["x"]))
trainer = train.build_trainer(
    compose(args["trainer"], config_dir=str(train.CONFIG_DIR)), device="cpu")
trainer.init_done()
assert trainer.load_model(args["ckpt"], resume=True) == args["epoch"] + 1
with torch.no_grad():
    heads = trainer.backend.module.eval()(x)
run = glob.glob("outputs/*/config.yaml")[0].rsplit("/", 1)[0]
shutil.copy(args["ckpt"], run + "/model_last.ckpt")
paths = export.main(["-e", run.split("/")[-1], "-i", str(x.shape[3]),
                     str(x.shape[2]), "-b", str(x.shape[0]), "-wd",
                     "--formats", "pt2", "--device", "cpu"])
served = export.load_artifact(paths[0]).module()(x)
np.savez(args["out"], **{"eager_" + k: v.numpy() for k, v in heads.items()},
         **{"served_" + k: v.detach().numpy() for k, v in served.items()})
torch.save(trainer.discriminator.state_dict(), args["disc"])
print(json.dumps({"log": [r.getMessage() for r in records],
                  "jax": [m for m in ("jax", "flax", "optax")
                          if sys.modules.get(m)]}))
"""


def test_jax_checkpoint_through_main_and_export(tmp_path):
    """A JAX ADVENT trainer's ``save_model(..., True)`` file (a pickle of
    numpy trees with optax states) loads, in a process that imports no
    JAX, through ``main(pretrained=...)`` (every weight restored, a test
    phase run), ``load_model(resume=True)`` (the JAX epoch, a fresh
    optimizer) and the export CLI; the eager and exported heads hold the
    JAX model's within the round trip's tolerance, the discriminator is
    the bridged one, bit for bit."""
    import subprocess
    import sys

    import yaml

    from centernet_uda_torch.utils.weights import disc_state_dict_from_jax
    from tests import test_torch_uda_twins as tw
    from tests.util_fixtures import make_tiny_coco

    ovr = tw.overrides("adversarial_entropy_minimization", ADVENT_SIZE)
    with tw.Twins():
        jm = tw.jax_trainer(ovr)
        jm.save_model(tmp_path / "jax_model.ckpt", 7, True)
        x = np.random.RandomState(5).randn(
            2, ADVENT_SIZE, ADVENT_SIZE, 3).astype(np.float32)
        want = jm.backend.module.apply(
            {"params": jm.state.params, "batch_stats": jm.state.batch_stats},
            x, train=False)
        want_disc = disc_state_dict_from_jax(
            jax.tree.map(np.asarray, jm.state.disc_params))
    np.save(tmp_path / "x.npy", x.transpose(0, 3, 1, 2).copy())

    img_dir, anno = make_tiny_coco(tmp_path / "coco", num_images=2,
                                   size=(ADVENT_SIZE, ADVENT_SIZE),
                                   num_classes=tw.NUM_CLASSES, seed=3)
    split = {"image_folder": str(img_dir), "annotation_file": str(anno),
             "input_size": [ADVENT_SIZE, ADVENT_SIZE],
             "target_domain_glob": f"{img_dir}/*"}
    data = [f"datasets.{phase}.params.{k}={json.dumps(v)}"
            for phase in ("training", "validation") for k, v in split.items()]
    data.append("datasets.test=" + yaml.safe_dump(
        {"name": "coco", "params": split}, default_flow_style=True,
        width=1 << 20).strip())
    port_ovr = ovr + tw.PORT_ONLY
    args = {"main": port_ovr + data + [
                "test_only=true", "num_workers=0",
                f"pretrained={tmp_path / 'jax_model.ckpt'}"],
            "trainer": port_ovr, "ckpt": str(tmp_path / "jax_model.ckpt"),
            "epoch": 7, "x": str(tmp_path / "x.npy"),
            "out": str(tmp_path / "heads.npz"),
            "disc": str(tmp_path / "disc.pt")}
    run = tmp_path / "run"
    run.mkdir()
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX_CHECKPOINT_RUN, json.dumps(args)],
        cwd=run, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-4000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["jax"] == []
    # main() and load_model each restore the discriminator, then the
    # model; the export CLI the model
    restored = [re.match(r"restored (\d+) of (\d+) weights", m)
                for m in report["log"]]
    restored = [m.groups() for m in restored if m]
    assert len(restored) == 5 and all(a == b for a, b in restored), restored
    assert any("optimizer starts fresh at epoch 7" in m
               for m in report["log"])

    heads = np.load(tmp_path / "heads.npz")
    for k, ref in want.items():
        ref = np.asarray(ref).transpose(0, 3, 1, 2)
        for kind in ("eager", "served"):
            np.testing.assert_allclose(
                heads[f"{kind}_{k}"], ref, rtol=1e-3,
                atol=1e-4 * max(1.0, np.abs(ref).max()), err_msg=(kind, k))
    got_disc = torch.load(tmp_path / "disc.pt", weights_only=True)
    assert set(got_disc) == set(want_disc)
    for k, v in want_disc.items():
        assert torch.equal(got_disc[k], v), k


def test_event_file_without_tensorboardx(tmp_path):
    """With tensorboardX (and TensorFlow, as on the card host) blocked, the
    logger writes through ``torch.utils.tensorboard``: the CLI's event file
    holds the ``MSCOCO_*`` scalars of its eval."""
    import subprocess
    import sys

    from tests.util_fixtures import make_tiny_coco

    img_dir, anno = make_tiny_coco(tmp_path / "coco", num_images=2,
                                   size=(64, 64), num_classes=3, seed=3)
    overrides = ["experiment=baseline", "dcn_impl=xla", "epochs=1",
                 "batch_size=2", "num_workers=0", "max_detections=10",
                 "model.backend.params.num_classes=3"] + NARROW[:3]
    for phase in ("training", "validation"):
        overrides += [f"datasets.{phase}.params.image_folder={img_dir}",
                      f"datasets.{phase}.params.annotation_file={anno}",
                      f"datasets.{phase}.params.input_size=[64,64]"]
    code = "\n".join([
        "import sys",
        "for name in ('tensorboardX', 'tensorflow', 'jax', 'flax', "
        "'optax'):",
        "    sys.modules[name] = None",
        "import logging",
        "logging.basicConfig(level=logging.INFO)",
        "from centernet_uda_torch import train",
        f"train.main({overrides!r}, device='cpu')",
        "from tensorboard.backend.event_processing.event_accumulator "
        "import EventAccumulator",
        f"ea = EventAccumulator({str(tmp_path / 'outputs/baseline/logs')!r})",
        "ea.Reload()",
        "print(sorted(ea.Tags()['scalars']))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-4000:]
    assert "through torch.utils.tensorboard.writer" in out.stderr
    tags = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    assert "MSCOCO_Precision/mAP" in tags and "MSCOCO_Recall/mAR100" in tags
    assert any(t.startswith("training/") for t in tags)
