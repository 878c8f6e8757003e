"""The port's COCO evaluator against the JAX package's, on the same
detections: every ``MSCOCO_*`` key, per-class entries included, within
1e-9 (NaN where the JAX package gives NaN). The port matches greedily in
pure Python; the JAX package's C++ matcher runs where it builds. Also the
port's columnar store: its two-decimal rounding is Python's, and it keeps
no Python object per detection."""

import gc

import numpy as np
import pytest

from centernet_uda_tpu.evaluation.coco import Evaluator as JaxEvaluator
from centernet_uda_torch.evaluation import build
from centernet_uda_torch.evaluation.coco import Evaluator, round2

CLASSES = {0: {"id": 1, "name": "car"}, 1: {"id": 2, "name": "truck"},
           2: {"id": 3, "name": "person"}, 3: {"id": 4, "name": "bike"}}


def batches(seed, n_batches=3, batch=4, k=30, rotated=False, classes=3,
            gt_range=(0, 12), ties=False, areas="given", empty=False,
            score_decimals=2, repeat_ids=False):
    """Detections and ground truth as ``Model.get_detections`` gives them:
    predictions near the gt (so the IoUs cover every threshold), false
    positives, score ties, gt of every area range and a missing class.

    ``ties`` puts box corners on a 0.005 grid (two-decimal rounding ties,
    exact in binary at the eighths); ``areas`` is "given", "nonpositive"
    (some gt areas 0 or below) or None (``gt_areas=None``); ``empty``
    leaves every third image without gt and every fourth without a
    score of 0.5 or more; ``repeat_ids`` gives every fifth image the id
    of an earlier one."""
    rng = np.random.RandomState(seed)
    image_id = 0
    for _ in range(n_batches):
        gt_boxes, gt_classes, gt_ids, gt_areas = [], [], [], []
        pred_boxes = np.zeros((batch, k, 5 if rotated else 4), np.float32)
        pred_classes = rng.randint(0, classes, (batch, k)).astype(np.int32)
        pred_scores = np.round(rng.rand(batch, k),
                               score_decimals).astype(np.float32)
        for i in range(batch):
            image_id += 1
            n = rng.randint(*gt_range)
            if empty and image_id % 3 == 0:
                n = 0
            if empty and image_id % 4 == 0:
                pred_scores[i] *= 0.49
            xy = rng.rand(n, 2) * 600
            wh = np.exp(rng.uniform(np.log(8), np.log(250), (n, 2)))
            if rotated:
                boxes = np.concatenate(
                    [xy, wh, rng.uniform(-90, 89, (n, 1))], 1)
            else:
                boxes = np.concatenate([xy, xy + wh], 1)
            gt_boxes.append(boxes.astype(np.float32))
            gt_classes.append(rng.randint(0, classes, n).astype(np.int32))
            gt_ids.append(np.int64(image_id - 3 if repeat_ids and
                                   image_id % 5 == 0 else image_id))
            area = wh[:, 0] * wh[:, 1]
            if areas == "nonpositive":
                area[rng.rand(n) < 0.3] = 0.0
                area[rng.rand(n) < 0.2] = -1.0
            gt_areas.append(area.astype(np.float32))
            for j in range(k):
                if n and rng.rand() < 0.6:
                    g = rng.randint(n)
                    jitter = rng.randn(boxes.shape[1]) * wh[g].mean() * 0.08
                    if rotated:
                        jitter[4] *= 20
                    pred_boxes[i, j] = boxes[g] + jitter
                    pred_classes[i, j] = gt_classes[-1][g]
                else:
                    x, y = rng.rand(2) * 600
                    w, h = rng.uniform(5, 200, 2)
                    pred_boxes[i, j, :4] = (x, y, w, h) if rotated else (
                        x, y, x + w, y + h)
        if ties:
            pred_boxes = (np.round(pred_boxes * 200) / 200).astype(np.float32)
            gt_boxes = [(np.round(b * 200) / 200).astype(np.float32)
                        for b in gt_boxes]
        yield dict(pred_boxes=pred_boxes, pred_classes=pred_classes,
                   pred_scores=pred_scores, gt_boxes=gt_boxes,
                   gt_classes=gt_classes, gt_ids=gt_ids,
                   gt_areas=None if areas is None else gt_areas,
                   image_shape=(3, 800, 800))


@pytest.mark.parametrize("seed,per_class,threshold,rotated,options", [
    (0, True, 0.0, False, {}),
    (1, True, 0.3, False, {}),
    (2, False, 0.0, False, {}),
    (3, True, 0.1, True, {}),
    # the 800 px eval cell's shape: k 150, 6 classes, 5-30 gt an image
    (4, True, 0.0, False, dict(n_batches=2, batch=16, k=150, classes=6,
                               gt_range=(5, 31))),
    (5, True, 0.0, False, dict(ties=True)),
    (6, True, 0.1, False, dict(ties=True, areas="nonpositive")),
    (7, True, 0.1, False, dict(areas=None)),
    (8, True, 0.5, False, dict(empty=True)),
    (9, True, 0.0, False, dict(score_decimals=1)),
    (10, True, 0.1, False, dict(repeat_ids=True)),
    (11, True, 0.1, True, dict(areas="nonpositive", empty=True)),
], ids=["per-class", "threshold", "means-only", "rotated", "cell-shape",
        "rounding-ties", "nonpositive-areas", "no-areas", "empty-images",
        "score-ties", "repeated-ids", "rotated-edges"])
def test_evaluate_equals_jax(seed, per_class, threshold, rotated,
                             options):
    port = build("coco", per_class=per_class, score_threshold=threshold)
    ref = JaxEvaluator(per_class=per_class, score_threshold=threshold)
    assert isinstance(port, Evaluator)
    for ev in (port, ref):
        ev.classes = CLASSES
        ev.use_rotated_boxes = rotated
    for kwargs in batches(seed, rotated=rotated, **options):
        port.add_batch(**kwargs)
        ref.add_batch(**kwargs)
    got, want = port.evaluate(), ref.evaluate()
    assert set(got) == set(want)
    assert "MSCOCO_Precision/mAP" in got
    if per_class:
        assert "MSCOCO_Class_truck/Precision/AP" in got
    assert any(np.isfinite(v) and v > 0 for v in want.values())
    for key, value in want.items():
        if np.isnan(value):
            assert np.isnan(got[key]), key
        else:
            assert abs(got[key] - value) <= 1e-9, (key, got[key], value)
    # evaluate() resets: a second round starts empty
    assert port.detections == [] and port.ground_truth == []


def test_round2_is_pythons_round():
    """``round2`` against Python's ``round(v, 2)``, bit for bit: ties
    exact in binary (the eighths), decimal ties that are not (x.xx5),
    their neighbours, negatives, values up to a few thousand, the edges
    of the fast path, and a seeded sample."""
    rng = np.random.RandomState(0)
    grid = np.arange(-400001, 400001, 6) / 200.0  # a third of x.xx5 to 2000
    eighths = np.arange(-32000, 32001) / 8.0
    near = np.concatenate([np.nextafter(grid, np.inf),
                           np.nextafter(grid, -np.inf)])
    float32 = (rng.rand(50000) * 4000 - 2000).astype(np.float32)
    sample = np.concatenate([
        rng.randn(50000) * 1000, rng.rand(50000) * 5000,
        np.float64(float32), np.float64(float32) - np.float64(float32[::-1]),
        [0.0, -0.0, 0.145, 0.285, 1.005, 2.675, -2.675, 2.0 ** 20,
         -(2.0 ** 20), 2.0 ** 20 - 0.005, 1e9 + 0.125, 1e15 + 0.5,
         np.inf, -np.inf, np.nan]])
    values = np.concatenate([grid, eighths, near, sample])
    got = round2(values)
    want = np.array([round(v, 2) for v in values.tolist()])
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got.view(np.int64)[~np.isnan(want)],
                                  want.view(np.int64)[~np.isnan(want)])
    assert np.isnan(got[np.isnan(want)]).all()


def test_store_holds_no_object_per_detection():
    """50 batches of 16 images x 150 detections, as the 800 px eval cell
    gives them, add a few tracked Python objects a batch (a dict and a
    list per detection would add thousands), and ``evaluate`` empties the
    store."""
    kwargs = list(batches(12, n_batches=5, batch=16, k=150, classes=6,
                          gt_range=(5, 31))) * 10
    port = build("coco", per_class=True, score_threshold=0.0)
    gc.collect()
    before = len(gc.get_objects())
    for kw in kwargs:
        port.add_batch(**kw)
    gc.collect()
    added = len(gc.get_objects()) - before
    assert added < 100 * len(kwargs), added
    assert len(port.detections) == len(port.ground_truth) == len(kwargs)
    stored = sum(len(d.score) for d in port.detections)
    assert stored == 50 * 16 * 150
    for d in port.detections:
        # the store owns its arrays: none is a view of the caller's
        assert all(c.base is None for c in d if c is not None)
    assert port.evaluate()["MSCOCO_Precision/mAP"] > 0
    assert port.detections == [] and port.ground_truth == []
    gc.collect()
    assert len(gc.get_objects()) - before < 100
