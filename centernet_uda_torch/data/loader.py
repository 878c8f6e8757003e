"""Batched, prefetching data loader.

A copy of ``centernet_uda_tpu/data/loader.py`` (it replaces the reference's
``torch.utils.data.DataLoader``, train.py:30-35), with PyTorch's step at the
device boundary:

- a thread pool decodes/augments samples concurrently (cv2/PIL/numpy release
  the GIL for the heavy work; the augmenters keep cv2's own pool off), or a
  forked process pool (``worker_mode="process"``),
- batches are collated into contiguous stacked numpy arrays with fully
  static shapes (``max_detections`` padding),
- with ``pin_memory`` the producer turns each collated array, except the
  ``host_keys`` the trainer keeps on the host, into a pinned CPU tensor, so
  the trainer's ``.to(device, non_blocking=True)`` is an asynchronous copy,
- an output queue prefetches ``prefetch`` batches ahead of the consumer,
  overlapping host work with device steps,
- a training shard (``num_shards`` > 1) is its rank's rows of each global
  batch, where the JAX package gives each host a slice of the epoch,
- a consumer that leaves early (``break``, an exception) gets control back
  within seconds in both worker modes: the producer stops submitting, and
  a process pool is shut down without ``Pool.terminate()`` while work is
  in flight (see ``_stop_process_pool``).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Sequence

import numpy as np
import torch

log = logging.getLogger(__name__)

# how long a loader that is left early waits for its workers: the tasks in
# flight, then the pool's exit, then the producer thread
STOP_TIMEOUT_S = 10.0


def collate(samples) -> Dict[str, np.ndarray]:
    """Stack a list of sample dicts into one batch dict."""
    batch = {}
    for key in samples[0]:
        batch[key] = np.stack([s[key] for s in samples])
    return batch


# fork-inherited dataset and stop flag for process workers (set right before
# the fork; children reference them without any pickling)
_PROC_DATASET = None
_PROC_STOP = None


def _proc_init():
    # keep cv2 from spawning a thread pool inside every worker process
    # (the reference guards the same way, datasets/coco.py:19)
    try:
        import cv2

        cv2.setNumThreads(0)
    except Exception:
        pass


def _proc_get(idx: int):
    # a task still queued when the consumer has left returns at once
    if _PROC_STOP.value:
        return None
    return _PROC_DATASET[int(idx)]


def _stop_process_pool(pool, in_flight, stop_flag, timeout: float) -> None:
    """Shut a ``multiprocessing.Pool`` down while tasks may be in flight.

    ``Pool.terminate()`` puts a sentinel on the result queue under the
    queue's write lock. A worker sending a result larger than the pipe's
    buffer holds that lock until the result handler reads it to the end;
    once terminate has stopped the result handler, nothing reads it, and
    terminate waits for the lock forever (8 workers and 256 px samples
    hang within a few early stops). So: the shared ``stop_flag`` turns
    every queued task into a no-op, every result in flight is collected
    (each worker finishes at most the sample it holds), and only then is
    the pool closed and joined, when no worker holds a queue lock. The
    whole stop is bounded by ``timeout``: where a sample does not finish
    in time, ``terminate()`` runs on a daemon thread that is left behind
    (logged), and the caller goes on."""
    stop_flag.value = 1
    deadline = time.monotonic() + timeout
    for f in in_flight:
        f.wait(max(deadline - time.monotonic(), 0.0))
    if all(f.ready() for f in in_flight):
        pool.close()
        stopper = threading.Thread(target=pool.join, daemon=True)
    else:
        stopper = threading.Thread(target=pool.terminate, daemon=True)
    stopper.start()
    stopper.join(max(deadline - time.monotonic(), 1.0))
    if stopper.is_alive():
        log.warning("a loader's worker processes did not stop within "
                    "%.0f s; left to exit on their own", timeout)


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 0,
        drop_last: bool = False,
        prefetch: int = 2,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
        worker_mode: str = "thread",
        pad_last: bool = False,
        pin_memory: bool = False,
        host_keys: Sequence[str] = (),
    ):
        """``batch_size`` is the PER-PROCESS batch. For multi-process
        training pass the process's rank as ``shard_id`` and the world size
        as ``num_shards``: every process then iterates a disjoint,
        same-length part of each (identically shuffled) epoch permutation,
        rank r rows ``r * batch_size .. (r + 1) * batch_size`` of each
        global batch of ``num_shards * batch_size`` samples, so the ranks
        together iterate the batches one process would with the global
        batch.

        ``worker_mode``: "thread" (default; cv2/numpy release the GIL for
        the heavy work) or "process" (forked worker pool — the reference's
        ``DataLoader(num_workers)`` model, train.py:30-35 — for pipelines
        whose Python-side augmentation contends on the GIL). Process mode
        forks a new pool on every iteration, and a fork after CUDA has
        started copies a process without the CUDA runtime's threads: the
        workers only read and augment images (they never touch CUDA), which
        is safe, but keep "thread" unless the augmentation is GIL-bound.

        ``pin_memory``: hand over each batch array as a pinned CPU tensor,
        except the ``host_keys`` (and the ``_num_real`` scalar), which stay
        numpy.

        ``pad_last``: instead of a short final batch, pad it to
        ``batch_size`` by repeating samples and record the real count in
        the batch as ``_num_real``. Keeps every sample while every batch
        stays mesh-divisible and hits the same compiled executable. With
        ``num_shards > 1`` the shards are strided (``indices[shard::n]``)
        so ALL ``len(dataset)`` samples are yielded exactly once across
        shards (the reference evaluates the full split,
        evaluation/coco.py:84-121), and every shard emits the SAME number
        of batches — a shard that runs out of real samples emits fully
        padded batches (``_num_real == 0``) so multi-host collectives stay
        in lockstep."""
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.num_workers = int(num_workers)
        self.pad_last = bool(pad_last)
        self.drop_last = (not self.pad_last) and (
            bool(drop_last) or num_shards > 1)
        self.prefetch = max(int(prefetch), 1)
        self.rng = np.random.RandomState(seed)
        self.shard_id = int(shard_id)
        self.num_shards = int(num_shards)
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be thread|process, "
                             f"got {worker_mode!r}")
        self.worker_mode = worker_mode
        self.pin_memory = bool(pin_memory)
        self.host_keys = frozenset(host_keys)

    def _shard_indices(self):
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(indices)
        if self.num_shards > 1:
            if self.pad_last:
                # strided: shard lengths differ by at most 1 and the union
                # covers every sample exactly once (full-split eval)
                indices = indices[self.shard_id::self.num_shards]
            else:
                per_batch = self.batch_size * self.num_shards
                usable = len(indices) // per_batch * per_batch
                indices = indices[:usable].reshape(
                    -1, self.num_shards, self.batch_size)[:, self.shard_id]
                indices = indices.reshape(-1)
        return indices

    def _shard_batches(self) -> int:
        """Number of batches every shard emits (identical across shards)."""
        if self.pad_last:
            longest = -(-len(self.dataset) // self.num_shards)
            return -(-longest // self.batch_size) if longest else 0
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __len__(self) -> int:
        return self._shard_batches()

    def _index_batches(self):
        """Yield (index_array, n_real) batches; n_real < batch_size only for
        a padded final batch (``pad_last``)."""
        indices = self._shard_indices()
        if self.drop_last:
            usable = (len(indices) // self.batch_size) * self.batch_size
            indices = indices[:usable]
        n_batches = 0
        for start in range(0, len(indices), self.batch_size):
            idx = indices[start : start + self.batch_size]
            n_real = len(idx)
            if self.pad_last and n_real < self.batch_size:
                # repeat real samples to fill; consumers slice with _num_real
                reps = -(-self.batch_size // n_real)
                idx = np.tile(idx, reps)[: self.batch_size]
            n_batches += 1
            yield idx, n_real
        if self.pad_last:
            # a shorter shard emits fully padded batches (n_real=0) until it
            # matches the longest shard's batch count, keeping multi-host
            # collectives in lockstep while the evaluator sees no duplicates
            fill = int(indices[0]) if len(indices) else 0
            idx = np.full((self.batch_size,), fill, dtype=np.int64)
            for _ in range(n_batches, self._shard_batches()):
                yield idx, 0

    def _finish(self, samples, n_real: int) -> Dict[str, np.ndarray]:
        batch = collate(samples)
        if n_real < len(samples):
            batch["_num_real"] = np.int64(n_real)
        if self.pin_memory:
            for k, v in batch.items():
                if isinstance(v, np.ndarray) and k not in self.host_keys:
                    batch[k] = torch.from_numpy(v).pin_memory()
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_workers <= 0:
            for idx_batch, n_real in self._index_batches():
                yield self._finish(
                    [self.dataset[int(i)] for i in idx_batch], n_real)
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """Bounded put that aborts when the consumer has gone away
            (never blocks forever on a full queue)."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            global _PROC_DATASET, _PROC_STOP
            pool = stop_flag = None
            # batches submitted and not yet handed over: (futures, n_real)
            pending = []

            def hand_over_first() -> bool:
                """Collate the oldest pending batch and put it on the
                queue; it leaves ``pending`` once all its results are in."""
                futures, n_real = pending[0]
                samples = [result(f) for f in futures]
                del pending[0]
                return put_or_stop(self._finish(samples, n_real))

            try:
                if self.worker_mode == "process":
                    import multiprocessing as mp

                    ctx = mp.get_context("fork")
                    stop_flag = ctx.RawValue("b", 0)
                    # inherited via fork
                    _PROC_DATASET, _PROC_STOP = self.dataset, stop_flag
                    pool = ctx.Pool(self.num_workers, initializer=_proc_init)
                    submit = lambda i: pool.apply_async(_proc_get, (i,))
                    result = lambda f: f.get()
                else:
                    pool = ThreadPoolExecutor(max_workers=self.num_workers)
                    submit = lambda i: pool.submit(
                        self.dataset.__getitem__, int(i))
                    result = lambda f: f.result()

                for idx_batch, n_real in self._index_batches():
                    if stop.is_set():
                        return
                    pending.append(([submit(int(i)) for i in idx_batch],
                                    n_real))
                    # keep at most `prefetch` batches in flight
                    while len(pending) > self.prefetch:
                        if not hand_over_first():
                            return
                while pending:
                    if not hand_over_first():
                        return
            except Exception as exc:  # surface worker errors to the consumer
                put_or_stop(exc)
            finally:
                if pool is not None:
                    if self.worker_mode == "process":
                        _stop_process_pool(
                            pool, [f for fs, _ in pending for f in fs],
                            stop_flag, STOP_TIMEOUT_S)
                    else:
                        pool.shutdown(wait=False, cancel_futures=True)
                put_or_stop(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()  # unblocks any in-flight bounded put
            # the producer's own stop is bounded by STOP_TIMEOUT_S; wait a
            # little longer for it, and never forever
            deadline = time.monotonic() + STOP_TIMEOUT_S + 5.0
            while thread.is_alive() and time.monotonic() < deadline:
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    pass
                thread.join(timeout=0.05)
            if thread.is_alive():
                log.warning("a loader's producer thread did not stop within "
                            "%.0f s; left behind (daemon)",
                            STOP_TIMEOUT_S + 5.0)
