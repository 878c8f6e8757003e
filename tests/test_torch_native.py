"""The port's host library (``centernet_uda_torch/native``, built with g++
from ``csrc/host_encoder.cpp``) on the CPU.

- Each function against its plain version on seeded inputs: bit for bit
  where both do the same float arithmetic (the radius on doubles, the box
  arrays, the normalisation, the matcher); the heatmap within 1e-6, since
  its exponential is numpy's on one side and the C library's on the other.
- The matcher on random IoU matrices with crowd and ignored ground truths
  and detections out of the area range.
- ``encode_targets``, ``normalize_image`` and the matcher against the JAX
  package's C++ library (``centernet_uda_tpu.native``), its heatmap and
  image transposed from HWC; skipped where that library does not build.
- A ``Dataset`` sample (augmented; with keypoints; with rotated boxes) and
  a COCO evaluation identical with the library and without it
  (``use_native_encoder=False``, ``CENTERNET_DISABLE_NATIVE``), the call
  counts showing which path ran.
- The library imports and runs in a process that loads no JAX, and a build
  pointed at a missing compiler raises.
"""

import json
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from centernet_uda_torch import native
from centernet_uda_torch.data.coco import Dataset, normalize_image
from centernet_uda_torch.evaluation.coco_eval_np import (IOU_THRS, COCOEval,
                                                         greedy_match)
from centernet_uda_torch.ops import gaussian
from tests.util_fixtures import make_tiny_coco

ROOT = Path(__file__).resolve().parents[1]
MEAN = (0.40789654, 0.44719302, 0.47026115)
STD = (0.28863828, 0.27408164, 0.27809835)
AUG = [{"Fliplr": {"p": 0.5}},
       {"Affine": {"scale": [0.8, 1.2], "translate_percent": [-0.1, 0.1]}},
       {"Multiply": {"mul": [0.8, 1.2]}}]


def random_boxes(rng, out_h, out_w, n):
    """Boxes in output-map pixels, some past the border, some empty."""
    xy = rng.rand(n, 2) * (out_w, out_h) * 1.1 - 3
    wh = rng.rand(n, 2) * (out_w, out_h) * 0.6
    wh[rng.rand(n) < 0.1] = 0
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def encode_cases(count=60, num_classes=5, max_det=20):
    rng = np.random.RandomState(0)
    for _ in range(count):
        out_h, out_w = rng.randint(4, 140, 2)
        n = rng.randint(0, 30)
        areas = [None if rng.rand() < 0.3 else float(rng.rand() * 900)
                 for _ in range(n)]
        yield (random_boxes(rng, out_h, out_w, n),
               rng.randint(0, num_classes, n), int(out_h), int(out_w),
               num_classes, max_det, areas)


def assert_targets_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        if k == "hm":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_gaussian_radius_and_draw_match_plain():
    # the sizes where float32 quadratics would round the radius otherwise
    for h, w in [(10, 10), (3, 37), (122, 682), (252, 852), (595, 754)]:
        assert native.gaussian_radius((h, w)) == \
            gaussian.gaussian_radius((float(h), float(w)))
    rng = np.random.RandomState(1)
    for _ in range(20):
        h, w = rng.randint(1, 50, 2)
        want = rng.rand(h, w).astype(np.float32) * 0.5
        got = want.copy()
        center, radius = (rng.randint(0, w), rng.randint(0, h)), \
            int(rng.randint(0, 12))
        gaussian.draw_gaussian(want, center, radius)
        native.draw_gaussian(got, center, radius)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_encode_targets_matches_plain():
    for boxes, classes, out_h, out_w, c, k, areas in encode_cases():
        assert_targets_equal(
            native.encode_targets(boxes, classes, out_h, out_w, c, k, areas),
            gaussian.encode_targets(boxes, classes, out_h, out_w, c, k,
                                    areas))


def test_encode_targets_refuses_a_class_outside_the_heatmap():
    boxes = np.array([[1, 1, 5, 5]], np.float32)
    with pytest.raises(ValueError, match="outside"):
        native.encode_targets(boxes, [3], 8, 8, 3, 4)


def test_normalize_image_matches_plain():
    rng = np.random.RandomState(2)
    for h, w in [(1, 1), (37, 53), (64, 48)]:
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        got = native.normalize_image(img, MEAN, STD)
        assert got.flags.c_contiguous
        np.testing.assert_array_equal(got, normalize_image(img, MEAN, STD))
    with pytest.raises(TypeError):
        native.normalize_image(img.astype(np.float32), MEAN, STD)


def match_cases(count=200):
    rng = np.random.RandomState(3)
    for _ in range(count):
        d, g = rng.randint(0, 14, 2)
        iou = rng.rand(d, g) * (rng.rand(d, g) < 0.7)
        iou[rng.rand(d, g) < 0.05] = 1.0
        yield (iou, np.sort(rng.rand(g) < 0.3), rng.rand(g) < 0.3,
               rng.rand(d) < 0.3)


def test_greedy_match_matches_plain():
    for iou, gt_ig, crowd, dt_out in match_cases():
        got = native.coco_greedy_match(iou, gt_ig, crowd, IOU_THRS, dt_out)
        want = greedy_match(iou, gt_ig, crowd, IOU_THRS, dt_out)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def jax_native():
    from centernet_uda_tpu import native as jax_lib

    if not jax_lib.available():
        pytest.skip("the JAX package's native library does not build")
    return jax_lib


def test_library_matches_the_jax_package_library():
    jax_lib = jax_native()
    for boxes, classes, out_h, out_w, c, k, areas in encode_cases(30):
        want = jax_lib.encode_targets(
            boxes, classes, np.array([-1 if a is None else a for a in areas],
                                     np.float32), out_h, out_w, c, k)
        want["hm"] = np.ascontiguousarray(want["hm"].transpose(2, 0, 1))
        assert_targets_equal(
            native.encode_targets(boxes, classes, out_h, out_w, c, k, areas),
            want)
    img = np.random.RandomState(4).randint(0, 256, (40, 24, 3), np.uint8)
    want = jax_lib.normalize_image(img, MEAN, STD).transpose(2, 0, 1)
    np.testing.assert_allclose(native.normalize_image(img, MEAN, STD), want,
                               rtol=0, atol=1e-6)
    for iou, gt_ig, crowd, dt_out in match_cases(50):
        dtm, dt_ig = jax_lib.coco_greedy_match(iou, gt_ig, crowd, IOU_THRS,
                                               dt_out)
        got = native.coco_greedy_match(iou, gt_ig, crowd, IOU_THRS, dt_out)
        np.testing.assert_array_equal(got[0], dtm)
        np.testing.assert_array_equal(got[1], dt_ig.astype(bool))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    return {kind: make_tiny_coco(root / kind, num_images=3, size=(80, 64),
                                 num_classes=3, max_objects=6, seed=5,
                                 rotated=kind == "rotated",
                                 num_keypoints=3 if kind == "kps" else 0)
            for kind in ("plain", "rotated", "kps")}


@pytest.mark.parametrize("kind", ["plain", "rotated", "kps"])
def test_dataset_sample_is_the_same_without_the_library(tiny, kind, caplog):
    img_dir, anno = tiny[kind]

    def samples(use_native):
        ds = Dataset(str(img_dir), str(anno), input_size=[64, 64],
                     num_classes=3, max_detections=10, augmentation=AUG,
                     seed=7, target_domain_glob=f"{img_dir}/*",
                     rotated_boxes=kind == "rotated",
                     num_keypoints=3 if kind == "kps" else 0,
                     use_native_encoder=use_native)
        native.reset_calls()
        out = [ds[i] for i in range(len(ds))]
        return out, dict(native.CALLS)

    with caplog.at_level(logging.INFO):
        want, plain_calls = samples(False)
    assert "use_native_encoder=False" in caplog.text
    got, calls = samples(True)
    assert not any(plain_calls.values())
    # rotated boxes keep their numpy encoder, as in the JAX package
    assert calls["encode_targets"] == (0 if kind == "rotated" else 3)
    assert calls["normalize_image"] == 6  # the image and its target domain
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_coco_eval_is_the_same_without_the_library(monkeypatch):
    rng = np.random.RandomState(6)
    gts, dts = [], []
    for image_id in range(6):
        for _ in range(rng.randint(0, 8)):
            x, y = rng.rand(2) * 300
            w, h = 5 + rng.rand(2) * 150
            gts.append({"image_id": image_id,
                        "category_id": int(rng.randint(1, 4)),
                        "bbox": [x, y, x + w, y + h], "area": w * h,
                        "iscrowd": int(rng.rand() < 0.15)})
        for _ in range(rng.randint(0, 12)):
            x, y = rng.rand(2) * 300
            w, h = 5 + rng.rand(2) * 150
            dts.append({"image_id": image_id,
                        "category_id": int(rng.randint(1, 4)),
                        "bbox": [x, y, x + w, y + h], "area": w * h,
                        "score": float(rng.rand())})
    # detections near each ground truth, so that most cells match
    for g in gts[::2]:
        box = np.array(g["bbox"]) + rng.randn(4) * 4
        dts.append({**g, "bbox": box.tolist(), "score": float(rng.rand())})

    def evaluate():
        native.reset_calls()
        ev = COCOEval(gts, dts)
        ev.evaluate_and_accumulate()
        return ev.eval, native.CALLS["coco_greedy_match"]

    got, calls = evaluate()
    monkeypatch.setenv(native.DISABLE_ENV, "1")
    want, plain_calls = evaluate()
    assert calls > 0 and plain_calls == 0
    assert np.nanmax(got["precision"]) > 0
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dataset_follows_the_environment_switch(tiny, monkeypatch):
    """Unset, ``use_native_encoder`` follows ``CENTERNET_DISABLE_NATIVE``,
    as the evaluator does; given, it decides for its dataset."""
    img_dir, anno = tiny["plain"]

    def calls(**kw):
        ds = Dataset(str(img_dir), str(anno), input_size=[64, 64],
                     num_classes=3, max_detections=10, seed=7, **kw)
        native.reset_calls()
        ds[0]
        return native.CALLS["encode_targets"]

    assert calls() == 1
    monkeypatch.setenv(native.DISABLE_ENV, "1")
    assert calls() == 0
    assert calls(use_native_encoder=True) == 1


def test_library_loads_without_jax():
    code = "\n".join([
        "import json, sys",
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'centernet_uda_tpu'):",
        "    sys.modules[name] = None",
        "import numpy as np",
        "from centernet_uda_torch import native",
        "t = native.encode_targets(np.array([[1, 1, 6, 5]]), [1], 8, 8, 2, 3)",
        "assert t['reg_mask'].tolist() == [1, 0, 0]",
        "roots = ('jax', 'jaxlib', 'flax', 'optax', 'centernet_uda_tpu')",
        "print(json.dumps(sorted(m for m in sys.modules",
        "                        if m.split('.')[0] in roots and sys.modules[m])))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_build_with_a_missing_compiler_raises(tmp_path):
    with pytest.raises(RuntimeError, match="building the host library"):
        native.build(build_dir=tmp_path, cxx=str(tmp_path / "no-such-g++"))
    assert not list(tmp_path.iterdir())
