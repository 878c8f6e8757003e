"""The port's training CLI with a UDA method on the CPU: ``main([...],
device="cpu")`` on ``make_tiny_coco`` with the target domain globbed from
the same images for training and validation, a narrow DLA and the exact
DCN op (``dcn_impl=xla``). ``experiment=entropy_minimization`` trains an
epoch at 64 px and evaluates; ``experiment=adversarial_entropy_minimization``
trains at 128 px (its discriminator needs a 32 x 32 heatmap), writes
``discriminator.ckpt`` beside ``model_last.ckpt`` and resumes both
optimizers."""

import logging
import math

import pytest
import torch

from centernet_uda_torch import train
from tests.util_fixtures import make_tiny_coco

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_coco(tmp_path_factory.mktemp("coco"), num_images=4,
                          size=(64, 64), num_classes=3, seed=3)


def overrides(tiny, experiment, size, *extra):
    img_dir, anno = tiny
    out = [f"experiment={experiment}", "dcn_impl=xla", "epochs=1",
           "batch_size=2", "num_workers=2", "max_detections=10",
           "model.backend.params.num_classes=3",
           "model.backend.params.levels=[1,1,1,1,1,1]",
           "model.backend.params.channels=[4,8,8,16,16,32]",
           "model.backend.params.head_conv=8"]
    for phase in ("training", "validation"):
        out += [f"datasets.{phase}.params.image_folder={img_dir}",
                f"datasets.{phase}.params.annotation_file={anno}",
                f"datasets.{phase}.params.input_size=[{size},{size}]",
                f"datasets.{phase}.params.target_domain_glob={img_dir}/*"]
    return out + list(extra)


def test_entropy_minimization_trains_and_evaluates(tiny, tmp_path,
                                                   monkeypatch):
    monkeypatch.chdir(tmp_path)
    phases = []
    scalars = train.main(overrides(tiny, "entropy_minimization", 64),
                         device="cpu", phases=phases)
    assert [(p["epoch"], p["tag"], p["steps"]) for p in phases] == [
        (1, "training", 2), (1, "validation", 2)]
    for key in ("training/total_loss", "training/entropy_loss",
                "validation/entropy_loss", "MSCOCO_Precision/mAP"):
        assert math.isfinite(scalars[key]), key
    run = tmp_path / "outputs" / "entropy_minimization"
    assert {"model_last.ckpt", "model_best.ckpt"} <= {
        p.name for p in run.iterdir()}


def test_adversarial_writes_and_resumes_the_discriminator(
        tiny, tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    ovr = overrides(tiny, "adversarial_entropy_minimization", 128)
    scalars = train.main(ovr, device="cpu")
    for key in ("training/dis_source", "training/dis_target",
                "training/dis_fool", "validation/dis_fool"):
        assert math.isfinite(scalars[key]), key
    run = tmp_path / "outputs" / "adversarial_entropy_minimization"
    disc = torch.load(run / "discriminator.ckpt", weights_only=True)
    assert disc["epoch"] == 1 and disc["optimizer"]["state"]
    assert set(disc["state_dict"]) == {f"{i}.{k}" for i in (0, 2, 4, 6, 8)
                                       for k in ("weight", "bias")}

    monkeypatch.chdir(tmp_path)
    phases = []
    with caplog.at_level(logging.INFO):
        train.main(ovr + ["epochs=2", f"resume={run}/model_last.ckpt"],
                   device="cpu", phases=phases)
    assert [(p["epoch"], p["tag"]) for p in phases] == [
        (2, "training"), (2, "validation")]
    # once for the discriminator, once for the model
    assert caplog.text.count("restore optimizer state at epoch 1") == 2
    assert torch.load(run / "discriminator.ckpt", weights_only=True)[
        "epoch"] == 2


def test_uda_cli_runs_on_the_card_unless_asked(tiny, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(overrides(tiny, "entropy_minimization", 64))
