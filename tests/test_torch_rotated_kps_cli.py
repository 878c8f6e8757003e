"""The port's training CLI on rotated boxes and keypoints, on the CPU:
``main([...], device="cpu")`` on ``make_tiny_coco(rotated=True,
num_keypoints=5)`` at 64 px for one epoch, at the experiments' full width:

- ``experiment=rotated`` with ``num_layers=18`` (ResNet, rotated boxes, the
  periodic angle loss);
- ``experiment=keypoints`` with ``gpu=null`` (EfficientNet-b0 with skips,
  5 keypoints, entropy minimization with the target domain globbed from the
  same images, CosineAnnealingLR);
- ``experiment=coco_merged`` with ``variant=b0`` (rotated boxes and
  keypoints, ``coco_merger`` over two copies of the set with the
  experiment's own augmentation, CosineAnnealingLR).

Each gives finite losses (``kp_loss`` where there are keypoints), the COCO
evaluator's ``MSCOCO_*`` results (rotated IoU for rotated boxes) and its
checkpoints.
"""

import math
from pathlib import Path

import pytest
import torch
import yaml

from centernet_uda_torch import train
from tests.util_fixtures import make_tiny_coco

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_coco(tmp_path_factory.mktemp("coco_rk"), num_images=4,
                          size=(64, 64), num_classes=3, seed=3, rotated=True,
                          num_keypoints=5)


def overrides(tiny, experiment, *extra, phases=("training", "validation")):
    img_dir, anno = tiny
    out = [f"experiment={experiment}", "epochs=1", "batch_size=2",
           "num_workers=2", "max_detections=10",
           "model.backend.params.num_classes=3"]
    for phase in ("training", "validation"):
        out.append(f"datasets.{phase}.params.input_size=[64,64]")
        if phase in phases:
            out += [f"datasets.{phase}.params.image_folder={img_dir}",
                    f"datasets.{phase}.params.annotation_file={anno}"]
    return out + list(extra)


def merged_sources(tiny):
    """``datasets.training.params.datasets`` as one YAML list (a dotted
    override cannot index into the list): two copies of the tiny set, each
    with the experiment's augmentation."""
    img_dir, anno = tiny
    exp = yaml.safe_load((ROOT / "configs" / "experiment" /
                          "coco_merged.yaml").read_text())
    sources = exp["datasets"]["training"]["params"]["datasets"]
    merged = [{"name": "coco", "params": {
        "image_folder": str(img_dir), "annotation_file": str(anno),
        "augmentation": s["params"]["augmentation"]}} for s in sources]
    return ("datasets.training.params.datasets="
            + yaml.safe_dump(merged, default_flow_style=True,
                             width=1 << 20).strip())


CASES = {
    "rotated": (["model.backend.params.num_layers=18"], True, False),
    "keypoints": (["gpu=null", "target_domain"], False, True),
    "coco_merged": (["model.backend.params.variant=b0", "merged"], True,
                    True),
}


@pytest.mark.parametrize("experiment", list(CASES))
def test_cli_trains_and_evaluates(tiny, tmp_path, monkeypatch, experiment):
    extra, rotated, kps = CASES[experiment]
    img_dir, _ = tiny
    args, phases_with_data = [], ("training", "validation")
    for item in extra:
        if item == "target_domain":
            args += [f"datasets.{p}.params.target_domain_glob={img_dir}/*"
                     for p in ("training", "validation")]
        elif item == "merged":
            args.append(merged_sources(tiny))
            phases_with_data = ("validation",)
        else:
            args.append(item)
    monkeypatch.chdir(tmp_path)
    phases = []
    scalars = train.main(overrides(tiny, experiment, *args,
                                   phases=phases_with_data),
                         device="cpu", phases=phases)
    assert [(p["epoch"], p["tag"]) for p in phases] == [
        (1, "training"), (1, "validation")]
    keys = ["training/total_loss", "training/wh_loss",
            "validation/total_loss", "MSCOCO_Precision/mAP",
            "MSCOCO_Precision/mAP.50IOU"]
    if kps:
        keys += ["training/kp_loss", "validation/kp_loss"]
    for key in keys:
        assert math.isfinite(scalars[key]), key
    run = next((tmp_path / "outputs").iterdir())
    assert {"config.yaml", "model_last.ckpt", "model_best.ckpt"} <= {
        p.name for p in run.iterdir()}
    state = torch.load(run / "model_last.ckpt", weights_only=True)
    assert state["state_dict"]["wh.2.weight"].shape[0] == (3 if rotated
                                                           else 2)
    assert ("kps.2.weight" in state["state_dict"]) == kps
