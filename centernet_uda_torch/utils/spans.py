"""Host spans of the port's own layers, on the profiler's clock.

``span(name)`` marks a stretch of host work (the phase loop's steps, the
compiled step's eager call, capture, staging and replay, the evaluation's
device-to-host read). While a ``torch.profiler`` records (the training
CLI's ``profile_steps`` trace, or a benchmark's traced window) it is a
``torch.profiler.record_function`` range: a ``user_annotation`` event in
the same trace as the device's kernels and copies, so the device's idle
time can be put down to the span it falls in. Otherwise it is one shared
no-op context: a span costs a check of the profiler's state and nothing
else (a bare ``record_function`` costs about 17 times as much with no
profiler on). Whether a profiler records is looked up when the span is
entered; there is no switch of its own.

With ``totals`` (a dict), the span adds its ``time.perf_counter``
duration under ``name`` whether a profiler records or not; a span left by
an exception adds nothing (``train._run_phase`` ends its loop on the
loader's ``StopIteration`` inside ``phase.batch_wait``, and the wait for
a batch that never came is no wait for a batch).

``gc.full``: the cyclic collector's full passes (generation 2), marked
from ``gc.callbacks`` while a profiler records. Such a pass stops the host
for up to about half a second wherever an allocation sets it off, so
without a name of its own it reads as the time of whichever span it fell
in.
"""

from __future__ import annotations

import gc
import time
from contextlib import nullcontext
from typing import Dict, Optional

import torch

_OFF = nullcontext()


def recording() -> bool:
    """Whether a ``torch.profiler`` records on this thread now."""
    return torch._C._autograd._profiler_enabled()


class _Timed:
    __slots__ = ("name", "totals", "record", "t0")

    def __init__(self, name: str, totals: Dict[str, float], record):
        self.name, self.totals, self.record = name, totals, record
        self.t0 = 0.0

    def __enter__(self):
        if self.record is not None:
            self.record.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.totals[self.name] = (self.totals.get(self.name, 0.0)
                                      + time.perf_counter() - self.t0)
        if self.record is not None:
            self.record.__exit__(exc_type, exc, tb)
        return False


_gc_open = []  # the record of a full pass under way


def _gc_span(phase: str, info: dict) -> None:
    if info["generation"] != 2:
        return
    if phase == "start":
        if recording():
            record = torch.profiler.record_function("gc.full")
            record.__enter__()
            _gc_open.append(record)
    elif _gc_open:
        _gc_open.pop().__exit__(None, None, None)


gc.callbacks.append(_gc_span)


def span(name: str, totals: Optional[Dict[str, float]] = None):
    """A context that marks ``name`` in the profiler's trace while one
    records, and adds its seconds to ``totals[name]`` where given."""
    record = torch.profiler.record_function(name) if recording() else None
    if totals is not None:
        return _Timed(name, totals, record)
    return _OFF if record is None else record
