"""The port's COCO evaluator against the JAX package's, on the same
detections: every ``MSCOCO_*`` key, per-class entries included, within
1e-9 (NaN where the JAX package gives NaN). The port matches greedily in
pure Python; the JAX package's C++ matcher runs where it builds."""

import numpy as np
import pytest

from centernet_uda_tpu.evaluation.coco import Evaluator as JaxEvaluator
from centernet_uda_torch.evaluation import build
from centernet_uda_torch.evaluation.coco import Evaluator

CLASSES = {0: {"id": 1, "name": "car"}, 1: {"id": 2, "name": "truck"},
           2: {"id": 3, "name": "person"}, 3: {"id": 4, "name": "bike"}}


def batches(seed, n_batches=3, batch=4, k=30, rotated=False):
    """Detections and ground truth as ``Model.get_detections`` gives them:
    predictions near the gt (so the IoUs cover every threshold), false
    positives, score ties, gt of every area range and a missing class."""
    rng = np.random.RandomState(seed)
    image_id = 0
    for _ in range(n_batches):
        gt_boxes, gt_classes, gt_ids, gt_areas = [], [], [], []
        pred_boxes = np.zeros((batch, k, 5 if rotated else 4), np.float32)
        pred_classes = rng.randint(0, 3, (batch, k)).astype(np.int32)
        pred_scores = np.round(rng.rand(batch, k), 2).astype(np.float32)
        for i in range(batch):
            image_id += 1
            n = rng.randint(0, 12)
            xy = rng.rand(n, 2) * 600
            wh = np.exp(rng.uniform(np.log(8), np.log(250), (n, 2)))
            if rotated:
                boxes = np.concatenate(
                    [xy, wh, rng.uniform(-90, 89, (n, 1))], 1)
            else:
                boxes = np.concatenate([xy, xy + wh], 1)
            gt_boxes.append(boxes.astype(np.float32))
            gt_classes.append(rng.randint(0, 3, n).astype(np.int32))
            gt_ids.append(np.int64(image_id))
            gt_areas.append((wh[:, 0] * wh[:, 1]).astype(np.float32))
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
        yield dict(pred_boxes=pred_boxes, pred_classes=pred_classes,
                   pred_scores=pred_scores, gt_boxes=gt_boxes,
                   gt_classes=gt_classes, gt_ids=gt_ids, gt_areas=gt_areas,
                   image_shape=(3, 800, 800))


@pytest.mark.parametrize("seed,per_class,threshold,rotated", [
    (0, True, 0.0, False),
    (1, True, 0.3, False),
    (2, False, 0.0, False),
    (3, True, 0.1, True),
], ids=["per-class", "threshold", "means-only", "rotated"])
def test_evaluate_equals_jax(seed, per_class, threshold, rotated):
    port = build("coco", per_class=per_class, score_threshold=threshold)
    ref = JaxEvaluator(per_class=per_class, score_threshold=threshold)
    assert isinstance(port, Evaluator)
    for ev in (port, ref):
        ev.classes = CLASSES
        ev.use_rotated_boxes = rotated
    for kwargs in batches(seed, rotated=rotated):
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
    assert port.pred_annos == [] and port.gt_annos == []
