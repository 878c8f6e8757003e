"""The port's data pipeline against the JAX package's, on the CPU.

Samples: on ``make_tiny_coco`` images the port's ``Dataset[i]`` equals
``centernet_uda_tpu.data.coco.Dataset(..., use_native_encoder=False)[i]``
for the same seed, byte for byte — every target key, and ``input`` too,
since both run the same OpenCV calls on the same draws of one numpy
``RandomState`` (the port returns ``input`` CHW and ``hm`` (C, h, w), the
JAX package HWC and (h, w, C); the test transposes). Against the JAX
package's C++ encoder and normaliser (``use_native_encoder=True``) the
samples agree within 1e-6. The loader gives the JAX loader's batches, and
the PPM reader gives what ``cv2.imread`` gives.
"""

import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

from centernet_uda_tpu.data.coco import Dataset as JaxDataset
from centernet_uda_tpu.data.loader import DataLoader as JaxDataLoader
from centernet_uda_torch.data.coco import Dataset, load_image, read_ppm, write_ppm
from centernet_uda_torch.data.loader import DataLoader
from tests.util_fixtures import make_tiny_coco

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
AUGMENTATION = yaml.safe_load((ROOT / "configs" / "defaults.yaml").read_text(
))["datasets"]["training"]["params"]["augmentation"]
# keys in the port's layout that the JAX package returns channels-last
CHANNELS_LAST = ("input", "hm", "target_domain_input")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    plain = make_tiny_coco(root / "plain", num_images=6, size=(80, 64),
                           num_classes=3, max_objects=6, seed=5)
    kps = make_tiny_coco(root / "kps", num_images=4, size=(64, 64),
                         num_classes=3, max_objects=4, seed=6,
                         num_keypoints=2)
    rot = make_tiny_coco(root / "rot", num_images=4, size=(64, 64),
                         num_classes=3, max_objects=4, seed=7, rotated=True)
    return {"plain": plain, "kps": kps, "rot": rot}


def pair(tiny, name, input_size, augmentation, seed=11, **kw):
    img_dir, anno = tiny[name]
    params = dict(image_folder=str(img_dir), annotation_file=str(anno),
                  input_size=input_size, num_classes=3, max_detections=8,
                  augmentation=augmentation, seed=seed, **kw)
    return Dataset(**params), JaxDataset(**params, use_native_encoder=False)


def as_port_layout(key, value):
    value = np.asarray(value)
    return value.transpose(2, 0, 1) if key in CHANNELS_LAST else value


@pytest.mark.parametrize("name,input_size,augmentation,extra", [
    ("plain", (80, 64), None, {}),
    ("plain", (96, 128), None, {}),      # Resize changes the size
    ("plain", (64, 64), AUGMENTATION, {}),
    ("plain", (128, 96), AUGMENTATION, {}),
    ("kps", (96, 96), AUGMENTATION, {"num_keypoints": 2}),
    ("rot", (96, 96), AUGMENTATION, {"rotated_boxes": True}),
], ids=["plain", "resized", "augmented", "augmented-resized",
        "keypoints", "rotated"])
def test_samples_equal_jax_bytes(tiny, name, input_size, augmentation, extra):
    port, ref = pair(tiny, name, input_size, augmentation, **extra)
    # two passes: the second starts from where the first left the rng
    for index in list(range(len(port))) * 2:
        got, want = port[index], ref[index]
        assert set(got) == set(want)
        for key in want:
            w = as_port_layout(key, want[key])
            g = np.asarray(got[key])
            assert g.dtype == w.dtype and g.shape == w.shape, key
            assert g.tobytes() == w.tobytes(), (key, index)


@pytest.mark.parametrize("augmentation", [None, AUGMENTATION],
                         ids=["plain", "augmented"])
def test_samples_match_the_native_encoder(tiny, augmentation):
    img_dir, anno = tiny["plain"]
    params = dict(image_folder=str(img_dir), annotation_file=str(anno),
                  input_size=(96, 96), num_classes=3, max_detections=8,
                  augmentation=augmentation, seed=3)
    port = Dataset(**params)
    ref = JaxDataset(**params, use_native_encoder=True)
    for index in range(len(port)):
        got, want = port[index], ref[index]
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(
                np.asarray(got[key], np.float64),
                as_port_layout(key, want[key]).astype(np.float64),
                rtol=0, atol=1e-6, err_msg=key)


class _Indexed:
    """A dataset of small samples that name their index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2, 3), i, np.float32), "id": np.int64(i),
                "mask": np.array([i % 2], np.uint8)}


def _batches(loader, epochs=2):
    return [batch for _ in range(epochs) for batch in loader]


@pytest.mark.parametrize("drop_last,pad_last,num_workers,worker_mode", [
    (False, False, 0, "thread"),
    (True, False, 2, "thread"),
    (False, True, 0, "thread"),
    (False, True, 3, "thread"),
    (False, False, 2, "process"),
], ids=["plain", "drop_last-threads", "pad_last", "pad_last-threads",
        "processes"])
def test_loader_matches_jax(drop_last, pad_last, num_workers, worker_mode):
    """Same shuffled order over two epochs, same collation, the same
    padding and ``_num_real``."""
    kw = dict(batch_size=3, shuffle=True, seed=7, drop_last=drop_last,
              pad_last=pad_last, num_workers=num_workers,
              worker_mode=worker_mode)
    got = _batches(DataLoader(_Indexed(10), **kw))
    want = _batches(JaxDataLoader(_Indexed(10), **kw))
    assert len(got) == len(want) == len(DataLoader(_Indexed(10), **kw)) * 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_loader_batches_of_the_dataset_match_jax(tiny):
    img_dir, anno = tiny["plain"]
    params = dict(image_folder=str(img_dir), annotation_file=str(anno),
                  input_size=(64, 64), num_classes=3, max_detections=8)
    kw = dict(batch_size=4, shuffle=True, seed=2, pad_last=True)
    got = list(DataLoader(Dataset(**params), **kw))
    want = list(JaxDataLoader(JaxDataset(**params, use_native_encoder=False),
                              **kw))
    assert [int(b.get("_num_real", 4)) for b in got] == [4, 2]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            want_value = np.asarray(w[key])
            if key in CHANNELS_LAST:
                want_value = want_value.transpose(0, 3, 1, 2)
            assert np.asarray(g[key]).tobytes() == want_value.tobytes(), key


def _cv2_rgb(path):
    img = cv2.imread(str(path),
                     cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def test_ppm_reader_equals_cv2(tmp_path):
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (13, 17, 3), np.uint8)
    grey = rng.randint(0, 256, (9, 11), np.uint8)
    write_ppm(tmp_path / "written.ppm", rgb)
    # a header with comments and irregular whitespace
    (tmp_path / "comments.ppm").write_bytes(
        b"P6 # a comment\n# another\n17\t13\n 255\n" + rgb.tobytes())
    (tmp_path / "grey.pgm").write_bytes(b"P5\n11 9\n255\n" + grey.tobytes())
    for name in ("written.ppm", "comments.ppm", "grey.pgm"):
        got = read_ppm(tmp_path / name)
        want = _cv2_rgb(tmp_path / name)
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(load_image(tmp_path / name), want)
    np.testing.assert_array_equal(read_ppm(tmp_path / "written.ppm"), rgb)


def test_other_formats_go_through_a_library(tiny, tmp_path, monkeypatch):
    """A PNG is not PPM: it is read by OpenCV; without OpenCV and PIL the
    error names both."""
    png = sorted(Path(tiny["plain"][0]).glob("*.png"))[0]
    assert read_ppm(png) is None
    np.testing.assert_array_equal(load_image(png), _cv2_rgb(png))
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="cv2.*PIL"):
        load_image(png)
    write_ppm(tmp_path / "a.ppm", np.zeros((2, 3, 3), np.uint8))
    assert load_image(tmp_path / "a.ppm").shape == (2, 3, 3)
