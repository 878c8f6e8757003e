"""The port's training CLI on the CPU: ``main([...], device="cpu")`` trains
a narrow DLA for 2 epochs on ``make_tiny_coco`` at 64 px with the exact DCN
op (``dcn_impl=xla``), evaluates, writes its run directory and resumes.
The JAX package's own CLI test is slow-marked, so its evaluator stands in
for it: on the detections the port's CLI evaluated, the JAX ``Evaluator``
returns the same ``MSCOCO_*`` keys."""

import json
import logging
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from centernet_uda_tpu.evaluation.coco import Evaluator as JaxEvaluator
from centernet_uda_torch import train
from centernet_uda_torch.evaluation.coco import Evaluator
from tests.torch_graph_stand_in import stand_in_graphs
from tests.util_fixtures import make_tiny_coco

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
RUN = "outputs/baseline"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_coco(tmp_path_factory.mktemp("coco"), num_images=6,
                          size=(64, 64), num_classes=3, seed=3)


def overrides(tiny, *extra):
    img_dir, anno = tiny
    out = ["experiment=baseline", "dcn_impl=xla", "epochs=2", "batch_size=2",
           "num_workers=2", "max_detections=10",
           "model.backend.params.num_classes=3",
           "model.backend.params.levels=[1,1,1,1,1,1]",
           "model.backend.params.channels=[4,8,8,16,16,32]",
           "model.backend.params.head_conv=8"]
    for phase in ("training", "validation"):
        out += [f"datasets.{phase}.params.image_folder={img_dir}",
                f"datasets.{phase}.params.annotation_file={anno}",
                f"datasets.{phase}.params.input_size=[64,64]"]
    return out + list(extra)


def test_train_evaluate_checkpoint_resume(tiny, tmp_path, monkeypatch,
                                          caplog):
    monkeypatch.chdir(tmp_path)
    seen = []
    add_batch = Evaluator.add_batch

    def record(self, **kwargs):
        seen.append(kwargs)
        return add_batch(self, **kwargs)

    monkeypatch.setattr(Evaluator, "add_batch", record)
    phases = []
    scalars = train.main(overrides(tiny), device="cpu", phases=phases)

    assert [(p["epoch"], p["tag"], p["steps"]) for p in phases] == [
        (1, "training", 3), (1, "validation", 3),
        (2, "training", 3), (2, "validation", 3)]
    assert all(p["evaluate_s"] >= 0 for p in phases
               if p["tag"] == "validation")
    assert all(math.isfinite(p["total_loss"]) for p in phases)
    for key in ("training/total_loss", "training/hm_loss",
                "validation/total_loss", "MSCOCO_Precision/mAP"):
        assert math.isfinite(scalars[key]), key
    run = tmp_path / RUN
    assert {"config.yaml", "model_last.ckpt", "model_best.ckpt"} <= {
        p.name for p in run.iterdir()}
    assert torch.load(run / "model_last.ckpt", weights_only=True)[
        "epoch"] == 2

    # the JAX evaluator on the last validation's detections
    ref = JaxEvaluator(per_class=True, score_threshold=0.0)
    ref.classes = {0: {"id": 1, "name": "class_1"},
                   1: {"id": 2, "name": "class_2"},
                   2: {"id": 3, "name": "class_3"}}
    for kwargs in seen[3:]:
        ref.add_batch(**kwargs)
    want = ref.evaluate()
    got = {k: v for k, v in scalars.items() if k.startswith("MSCOCO_")}
    assert set(got) == set(want)
    assert "MSCOCO_Class_class_1/Precision/AP" in got
    for k, v in want.items():
        assert (np.isnan(v) and np.isnan(got[k])) or abs(got[k] - v) <= 1e-9

    # resume: only epoch 3 runs, from the restored optimizer
    monkeypatch.chdir(tmp_path)
    phases = []
    with caplog.at_level(logging.INFO):
        train.main(overrides(tiny, "epochs=3", f"resume={RUN}/model_last.ckpt",
                             "--device", "cpu"), phases=phases)
    assert "restore optimizer state at epoch 2" in caplog.text
    assert [(p["epoch"], p["tag"]) for p in phases] == [
        (3, "training"), (3, "validation")]
    assert torch.load(run / "model_last.ckpt", weights_only=True)[
        "epoch"] == 3


def test_profile_steps_writes_a_trace(tiny, tmp_path, monkeypatch):
    """The operator's trace holds the program's spans: the phase loop's
    ``phase.step`` and the compiled step's first, eager call (the CPU's
    steps go through the stand-in graph here, as the card's are graphed)."""
    build = train.build_trainer

    def graphed(*args, **kwargs):
        trainer = build(*args, **kwargs)
        stand_in_graphs(trainer)
        return trainer

    monkeypatch.setattr(train, "build_trainer", graphed)
    monkeypatch.chdir(tmp_path)
    train.main(overrides(tiny, "epochs=1", "profile_steps=2",
                         "eval_at_n_epoch=2"), device="cpu")
    path = tmp_path / RUN / "profile" / "trace.json"
    assert path.stat().st_size > 0
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {"phase.step", "graphs.eager"} <= names


@pytest.mark.parametrize("extra,error,match", [
    # ImageNet trunk weights need the torch hub cache; nothing is downloaded
    (["model.backend.params.pretrained=true"], FileNotFoundError,
     "no cached weights"),
])
def test_unported_configs_raise(tiny, tmp_path, monkeypatch, extra, error,
                                match):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    with pytest.raises(error, match=match):
        train.main(overrides(tiny, *extra), device="cpu")


def test_two_device_config_trains_on_one_device(tiny, tmp_path, monkeypatch,
                                                caplog):
    """``gpu: [0, 1]`` (the reference's DataParallel switch) on the CPU, one
    device: the JAX package's warning, then an epoch on that device."""
    monkeypatch.chdir(tmp_path)
    with caplog.at_level(logging.WARNING, logger="uda"):
        scalars = train.main(overrides(tiny, "gpu=[0,1]", "epochs=1"),
                             device="cpu")
    assert ("requested 2-way data parallelism but only 1 device(s) "
            "available; running single-device") in caplog.text
    assert math.isfinite(scalars["validation/total_loss"])
    assert (tmp_path / RUN / "model_last.ckpt").is_file()


def test_runs_on_the_card_unless_asked(tiny, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(overrides(tiny))


def test_module_entry_point(tiny, tmp_path):
    """``python -m centernet_uda_torch.train --device cpu ...`` runs an
    epoch and writes its checkpoints under the working directory."""
    out = subprocess.run(
        [sys.executable, "-m", "centernet_uda_torch.train", "--device", "cpu",
         *overrides(tiny, "epochs=1", "num_workers=0")],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "epoch 1 training done" in out.stderr
    assert (tmp_path / RUN / "model_last.ckpt").is_file()
