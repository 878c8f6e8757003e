#!/usr/bin/env python
"""Host input-pipeline bench of the PyTorch port: what a sample costs.

    IMAGES=96 SIZE=512 BATCH=16 WORKERS=8 MODE=thread AUG=1 SECONDS=15 \\
        python tools/bench_pipeline_torch.py

The port's ``Dataset`` and ``DataLoader`` (``centernet_uda_torch/data``) on
a synthetic COCO set made from a seed (``tests/util_fixtures.py``'s
``make_tiny_coco``: 6 classes, up to 16 boxes an image), its PNGs
re-encoded to JPEG, the format of COCO, so that decoding is JPEG decoding.
``AUG=1`` takes the training augmentation of ``configs/defaults.yaml`` (what
``experiment=baseline`` trains with). The knobs are those of
``tools/bench_pipeline.py``; ``SECONDS`` is the length of each timed loader
run.

Everything runs twice: with the host library (``centernet_uda_torch/native``:
target encoder and normalisation in C++) and with their numpy versions
(``use_native_encoder=False``). Each time:

- a pass over every image on this thread (``MODE`` aside) times each stage
  of a sample: ``decode`` (``load_image``), ``augment`` (the augmenters and
  the resize to ``SIZE``), ``normalise``, ``encode`` (the box targets),
  ``other`` (the rest of ``__getitem__``: annotations, the target arrays'
  bookkeeping), then per batch ``collate`` and ``pin`` (each array to a
  pinned tensor, as the loader hands a batch to the card; null without
  CUDA), all in ms a sample;
- the loader (``MODE`` thread, process or sync, ``WORKERS``, pinned where
  CUDA is available) runs whole epochs for ``SECONDS``, after a warm-up
  epoch: ``pipeline_images_per_sec``.

Prints one JSON line: the library's numbers at the top level and the numpy
versions' under ``numpy``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

STAGES = ("decode", "augment", "normalise", "encode", "other", "collate",
          "pin")


def write_jpeg_coco(root: Path, n_images: int, size: int, seed: int = 0):
    """``make_tiny_coco`` at ``size`` px with its images as JPEG; returns
    (image folder, annotation file)."""
    from PIL import Image
    from util_fixtures import make_tiny_coco

    img_dir, anno = make_tiny_coco(root, num_images=n_images,
                                   size=(size, size), num_classes=6,
                                   max_objects=16, seed=seed)
    coco = json.loads(Path(anno).read_text())
    for image in coco["images"]:
        png = img_dir / image["file_name"]
        image["file_name"] = png.with_suffix(".jpg").name
        Image.open(png).save(img_dir / image["file_name"], quality=90)
        png.unlink()
    Path(anno).write_text(json.dumps(coco))
    return img_dir, anno


def default_augmentation():
    from centernet_uda_torch.config import compose

    cfg = compose([], config_dir=str(ROOT / "configs"))
    return cfg.datasets.training.params.to_dict()["augmentation"]


class _Timer:
    """Seconds spent in each stage; ``wrap`` times a callable into one."""

    def __init__(self):
        self.s = {name: 0.0 for name in STAGES}

    def wrap(self, stage, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.s[stage] += time.perf_counter() - t0
        return timed


@contextmanager
def _timed_stages(ds, timer: _Timer):
    """Route the stages of the dataset ``ds`` through ``timer`` (for good:
    time ``ds`` in one pass only)."""
    from centernet_uda_torch.data import coco

    if ds.augmentation is not None:
        ds.augmentation = timer.wrap("augment", ds.augmentation)
    ds.resize = timer.wrap("augment", ds.resize)
    ds._normalize = timer.wrap("normalise", ds._normalize)
    ds._encode_boxes = timer.wrap("encode", ds._encode_boxes)
    load_image = coco.load_image
    coco.load_image = timer.wrap("decode", load_image)
    try:
        yield
    finally:
        coco.load_image = load_image


def stage_ms(ds, batch: int) -> Dict[str, Optional[float]]:
    """ms a sample of each stage, over one pass of ``ds`` on this thread
    after a warm-up sample."""
    import torch

    from centernet_uda_torch.data.loader import collate

    ds[0]  # warm-up: the first image's imports and caches
    if torch.cuda.is_available():
        torch.empty(1).pin_memory()  # and CUDA's start, which pinning needs
    timer = _Timer()
    total = 0.0
    n = len(ds) // batch * batch
    with _timed_stages(ds, timer):
        for start in range(0, n, batch):
            t0 = time.perf_counter()
            samples = [ds[i] for i in range(start, start + batch)]
            total += time.perf_counter() - t0
            out = timer.wrap("collate", collate)(samples)
            if torch.cuda.is_available():
                timer.wrap("pin", lambda b: [
                    torch.from_numpy(v).pin_memory() for v in b.values()])(out)
    timer.s["other"] = total - sum(timer.s[k] for k in (
        "decode", "augment", "normalise", "encode"))
    ms = {k: 1e3 * v / n for k, v in timer.s.items()}
    if not torch.cuda.is_available():
        ms["pin"] = None
    return ms


def loader_rate(ds, batch: int, workers: int, mode: str,
                seconds: float) -> Dict:
    """Images a second through the ``DataLoader`` over whole epochs for at
    least ``seconds`` after a warm-up epoch."""
    import torch

    from centernet_uda_torch.data.loader import DataLoader

    loader = DataLoader(ds, batch_size=batch, shuffle=True,
                        num_workers=0 if mode == "sync" else workers,
                        worker_mode="thread" if mode == "sync" else mode,
                        drop_last=True, prefetch=4,
                        pin_memory=torch.cuda.is_available())
    # a warm-up epoch: the workers' first samples (imports, caches)
    for _ in loader:
        pass
    n, epochs = 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for b in loader:
            n += len(b["input"])
        epochs += 1
    dt = time.perf_counter() - t0
    return {"pipeline_images_per_sec": n / dt, "epochs": epochs,
            "seconds": dt}


def bench(images: int = 96, size: int = 512, batch: int = 16,
          workers: int = 8, mode: str = "thread", aug: bool = True,
          seconds: float = 15.0, root: Optional[Path] = None) -> Dict:
    """The bench's record: knobs, and per encoder (the host library at the
    top level, numpy under ``numpy``) the stage times and the loader's
    rate."""
    import torch

    from centernet_uda_torch.data.coco import Dataset

    if mode not in ("thread", "process", "sync"):
        raise ValueError(f"MODE must be thread, process or sync: {mode!r}")
    with tempfile.TemporaryDirectory(prefix="bench_pipe_",
                                     dir=root) as tmp:
        img_dir, anno = write_jpeg_coco(Path(tmp), images, size)
        augmentation = default_augmentation() if aug else None
        out = {"images": images, "size": size, "batch": batch,
               "workers": workers, "mode": mode, "aug": aug,
               "cuda": torch.cuda.is_available()}
        for use_native in (True, False):
            def dataset():
                return Dataset(str(img_dir), str(anno),
                               input_size=[size, size],
                               augmentation=augmentation, num_classes=6,
                               max_detections=150, seed=0,
                               use_native_encoder=use_native)

            record = {"stage_ms_per_sample": stage_ms(dataset(), batch),
                      **loader_rate(dataset(), batch, workers, mode,
                                    seconds)}
            if use_native:
                out.update(record)
            else:
                out["numpy"] = record
    return out


def main() -> int:
    env = os.environ
    record = bench(images=int(env.get("IMAGES", 96)),
                   size=int(env.get("SIZE", 512)),
                   batch=int(env.get("BATCH", 16)),
                   workers=int(env.get("WORKERS", 8)),
                   mode=env.get("MODE", "thread"),
                   aug=env.get("AUG", "1") == "1",
                   seconds=float(env.get("SECONDS", 15)))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
