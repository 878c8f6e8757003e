"""A consumer that leaves the port's ``DataLoader`` early gets control back.

ROADMAP C3: with ``worker_mode="process"``, 8 workers and samples of 256
px under the training augmentation, a consumer that left after one batch
hung for good: the producer's ``Pool.terminate()`` waited on the result
queue's write lock, held by a worker whose large result nobody read any
more. Each case runs in a subprocess (its own process tree, killed as a
group at the time limit) on a seeded COCO set of 32 PNGs at 256 px, batch
8 (the reproducer of ROADMAP C3); the loader leaves after one batch
``STOPS`` times, and each stop must return within ``STOP_S``. A worker
that raises must surface its exception in the consumer as quickly, in
both modes.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

from util_fixtures import make_tiny_coco

ROOT = Path(__file__).resolve().parents[1]
IMAGES, SIZE, BATCH = 32, 256, 8
STOPS = 4
# a stop takes about 0.3 s on an idle 8-core host; it must come back within
# a few seconds, and the whole case within the subprocess's time limit
STOP_S = 5.0
CASE_TIMEOUT_S = 60

SCRIPT = r"""
import faulthandler, json, sys, time
faulthandler.dump_traceback_later({timeout}, exit=True)
import torch
torch.set_num_threads(1)
sys.path.insert(0, {root!r})
from centernet_uda_torch.config import compose
from centernet_uda_torch.data.coco import Dataset
from centernet_uda_torch.data.loader import DataLoader

img, anno, mode, workers, stops, raise_at = sys.argv[1:7]
aug = compose([], config_dir={root!r} + "/configs").datasets.training.params
aug = aug.to_dict()["augmentation"]


class Failing(Dataset):
    def __getitem__(self, idx):
        if idx == int(raise_at):
            raise ValueError(f"sample {{idx}} is broken")
        return super().__getitem__(idx)


ds = Failing(img, anno, input_size=[{size}, {size}], num_classes=6,
             max_detections=150, seed=0, augmentation=aug)
seconds, raised = [], []
for _ in range(int(stops)):
    loader = DataLoader(ds, batch_size={batch}, shuffle=int(raise_at) < 0,
                        num_workers=int(workers), worker_mode=mode,
                        drop_last=True, prefetch=4)
    t0 = time.perf_counter()
    try:
        for i, batch in enumerate(loader):
            assert batch["input"].shape == ({batch}, 3, {size}, {size})
            t0 = time.perf_counter()
            if i == 0 and int(raise_at) < 0:
                break
    except ValueError as exc:
        raised.append(str(exc))
    seconds.append(time.perf_counter() - t0)
print(json.dumps({{"seconds": seconds, "raised": raised}}))
"""


@pytest.fixture(scope="module")
def coco_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("loader_stop")
    return make_tiny_coco(root, num_images=IMAGES, size=(SIZE, SIZE),
                          num_classes=6, max_objects=16, seed=0)


def run_case(coco_set, mode, workers, stops=STOPS, raise_at=-1):
    """The case's record: seconds each stop took to return, and the
    exceptions the consumer saw."""
    img, anno = coco_set
    script = SCRIPT.format(timeout=CASE_TIMEOUT_S - 10, root=str(ROOT),
                           size=SIZE, batch=BATCH)
    env = {**os.environ, "CENTERNET_DISABLE_NATIVE": "1",
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-c", script, str(img), str(anno), mode,
         str(workers), str(stops), str(raise_at)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=CASE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"{mode} loader, {workers} workers: no return within "
                    f"{CASE_TIMEOUT_S} s\n{err[-3000:]}")
    finally:
        try:  # the forked workers, should any be left
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("mode,workers", [
    ("process", 8), ("process", 4), ("process", 2),
    ("thread", 8), ("thread", 4), ("thread", 2)])
def test_leaving_after_one_batch_returns(coco_set, mode, workers):
    rec = run_case(coco_set, mode, workers)
    assert len(rec["seconds"]) == STOPS and not rec["raised"]
    assert max(rec["seconds"]) < STOP_S, rec


@pytest.mark.parametrize("mode", ["process", "thread"])
def test_worker_exception_reaches_the_consumer(coco_set, mode):
    """Sample 10 (the second batch, unshuffled) raises in its worker: the
    consumer gets the first batch, then the ``ValueError``, quickly."""
    rec = run_case(coco_set, mode, 8, stops=2, raise_at=10)
    assert rec["raised"] == ["sample 10 is broken"] * 2, rec
    assert max(rec["seconds"]) < STOP_S, rec


def test_pipeline_stage_in_process_mode():
    """``tools/bench_pipeline_torch.py`` in a fresh process, small: 16
    JPEGs of 64 px, batch 4, 4 worker processes, 1 s a loader run; it must
    finish in its time and give a rate."""
    env = {**os.environ, "IMAGES": "16", "SIZE": "64", "BATCH": "4",
           "WORKERS": "4", "SECONDS": "1", "MODE": "process"}
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "bench_pipeline_torch.py")],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    line = out.stdout.strip().splitlines()[-1]
    assert json.loads(line)["pipeline_images_per_sec"] > 0
