"""A configuration with rotated boxes and keypoints, taken from its files
alone: DLA-34 with ``rotated_boxes``, five keypoints and the loss of
``configs/experiment/coco_merged.yaml`` (``dla34_rotated_kps.json``
beside this file; no cell of ``BENCHMARK.json`` lists it). Whole CPU runs
of ``harness.run_cell``, as in ``test_perfbench_faults.py``, must come out
correct, and each fault planted in the timed path must turn ``correct``
false: the loss's angle term dropped, its keypoint pair term dropped, the
decoded angle negated, the ``kps`` head zeroed before the decode.

The limits are the DLA-34 cells' (``perfbench/limits/``) and, for the two
numbers those cells do not have, 1 degree and 1 input pixel: the sound
CPU runs read 0 in both, the faults tens of degrees and pixels. The card's
limits for such a cell come from ``calibrate.py``.
"""

import numpy as np
import pytest
import torch

from perfbench import check, gen, harness

SEED = 2 ** 33 + 101
SMALL = {"input_size": 64, "batch": 1, "objects": [2, 4], "box_px": [8, 24]}
CONFIG = "perfbench/tests/dla34_rotated_kps.json"
NAME = "dla34_rotated_kps"
NEW = {"angle_gap": 1.0, "kps_gap": 1.0}
LIMITS = {
    "train_512": harness.load_json(
        harness.HERE / "limits" / "dla34_baseline.train_512.json")["limits"],
    "eval_800": {**harness.load_json(
        harness.HERE / "limits" / "dla34_baseline.eval_800.json")["limits"],
        **NEW},
    "serve_b1": {**harness.load_json(
        harness.HERE / "limits" / "dla34_baseline.serve_b1.json")["limits"],
        **NEW},
}


@pytest.fixture
def cells(monkeypatch):
    """The benchmark with this configuration's cells added, as
    ``harness.with_waiting`` adds the waiting ones, and their limits."""
    bench = harness.spec()
    bench["configs"] = bench["configs"] + [{"name": NAME, "file": CONFIG}]
    bench["workloads"] = bench["workloads"] + [
        {"name": f"{NAME}.{t}", "config": NAME, "traffic": t, "chips": 1}
        for t in LIMITS]
    real = harness.cell_files

    def cell_files(b, workload):
        if not workload.startswith(f"{NAME}."):
            return real(b, workload)
        traffic = workload.split(".", 1)[1]
        return {"cell": {c["name"]: c for c in b["workloads"]}[workload],
                "config": harness.load_json(harness.ROOT / CONFIG),
                "mix": harness.load_json(harness.HERE / "mixes"
                                         / f"{traffic}.json"),
                "limits": {"limits": LIMITS[traffic]}}

    monkeypatch.setattr(harness, "spec", lambda: bench)
    monkeypatch.setattr(harness, "cell_files", cell_files)


def run(traffic, patch=None, **mix):
    return harness.run_cell(f"{NAME}.{traffic}", SEED, 0.5, False,
                            device="cpu", overrides=["dcn_impl=cuda"],
                            mix_overrides={**SMALL, **mix}, patch=patch,
                            emit=False)


def no_angle_term(trainer):
    trainer.centernet_loss.angle_weight = 0.0


def no_pair_term(trainer):
    trainer.centernet_loss.kp_indices = None


def decoded(fault):
    """A patch that plants ``fault`` on what the program's decode gets
    or returns."""
    def patch(trainer):
        inner = trainer._decode
        trainer._decode = lambda heads: fault(inner, heads)
    return patch


@decoded
def negated_angle(inner, heads):
    dets, kps = inner(heads)
    dets = torch.cat((dets[..., :4], -dets[..., 4:5], dets[..., 5:]), -1)
    return dets, kps


@decoded
def zeroed_kps(inner, heads):
    return inner({**heads, "kps": torch.zeros_like(heads["kps"])})


def zeroed_served_kps(module):
    def served(x):
        boxes, scores, classes, kps = module(x)
        return boxes, scores, classes, torch.zeros_like(kps)

    return served


def test_train(cells):
    assert run("train_512")["correct"]
    assert not run("train_512", no_angle_term)["correct"]
    assert not run("train_512", no_pair_term)["correct"]


def test_eval(cells):
    sound = run("eval_800")
    assert sound["correct"]
    assert set(NEW) <= set(sound["checks"])
    assert not run("eval_800", negated_angle)["correct"]
    assert not run("eval_800", zeroed_kps)["correct"]


def test_serve(cells):
    # 128 px: the served k = 150 needs more peaks than a 16 x 16 map has
    assert run("serve_b1", input_size=128)["correct"]
    assert not run("serve_b1", zeroed_served_kps,
                   input_size=128)["correct"]


def test_targets():
    """Rotated and keypoint targets as the port's loader keys them, drawn
    from a stream of their own: the boxes, heatmaps and centers are those
    of the same seed without these heads."""
    ref = harness.load_json(harness.ROOT / CONFIG)["reference"]
    plain = {**ref["heads"], "wh": 2}
    plain.pop("kps")
    mix = {"cycle": 2, **SMALL, "batch": 3, "objects": [5, 9]}
    got = gen.batches(mix, SEED, 3, ref["heads"], 150, False, "cpu")
    base = gen.batches(mix, SEED, 3, plain, 150, False, "cpu")
    for b, p in zip(got, base):
        for key in ("input", "hm", "reg", "ind", "reg_mask"):
            assert torch.equal(b[key], p[key]), key
        mask = b["reg_mask"].bool()
        wh, dets = b["wh"][mask], b["gt_dets"][mask.numpy()]
        assert wh.shape[-1] == 3 and dets.shape[-1] == 7
        assert (wh[:, 0] <= wh[:, 1]).all()
        assert ((wh[:, 2] >= -90) & (wh[:, 2] < 90)).all()
        assert np.array_equal(dets[:, 2:5], wh.numpy())
        # the axis-aligned box's (w, h), the shorter side first
        assert torch.equal(p["wh"][mask].sort(-1).values, wh[:, :2])
        assert b["kps"].shape[-1] == b["kp_reg_mask"].shape[-1] == 10
        assert b["gt_kps"].shape[-2:] == (5, 2)
        seen = b["kp_reg_mask"][mask].float().mean()
        assert 0.5 < float(seen) < 1.0
        # the points' offsets from the integer center
        ind = b["ind"][mask]
        centers = torch.stack((ind % 16, ind // 16), -1).float()
        pts = torch.from_numpy(b["gt_kps"][mask.numpy()])
        assert torch.allclose(b["kps"][mask].reshape(-1, 5, 2),
                              pts - centers[:, None], atol=1e-5)


def test_a_net_is_found_by_name():
    assert "dla34" in check.nets() and "train" not in check.nets()
    for ref in ({"net": "no_such_net"}, {}):
        with pytest.raises(ValueError, match="dla34"):
            check.make_net(ref)
