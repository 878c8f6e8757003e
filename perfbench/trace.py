"""The traced part of a window and what the trace says.

``Tracer`` runs ``torch.profiler`` (CPU and CUDA activities) over a steady
part of a ``--trace 1`` run's window: it synchronises the device before it
starts and before it stops, so every device operation of the work traced
lies inside it. The trace is written to ``build/perfbench/traces/
<workload>.json`` in the checkout (one fixed path a cell, overwritten by
each traced run) and read back here:

- ``busy_s``: the union of the device's operation intervals (kernels,
  copies, fills): overlapping kernels count once, so it never passes the
  traced window;
- kernel time and launch counts by name;
- the idle gaps between device operations, each named by the host
  operation that spans most of it (the benchmark's own spans, ``perfbench.*``,
  mark the calls into the program's layers).
"""

from __future__ import annotations

import gc
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
NAME_CHARS = 160


def union_seconds(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def merged(intervals: Sequence[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def gap_label(gap: Tuple[float, float],
              host: Sequence[Tuple[float, float, str]]) -> str:
    """The host operation that covers at least half of the gap, the
    shortest such; else the one that overlaps it most."""
    g0, g1 = gap
    need = 0.5 * (g1 - g0)
    best, best_len = None, None
    most, most_overlap = None, 0.0
    for s, e, name in host:
        overlap = min(e, g1) - max(s, g0)
        if overlap <= 0:
            continue
        if overlap >= need and (best_len is None or e - s < best_len):
            best, best_len = name, e - s
        if overlap > most_overlap:
            most, most_overlap = name, overlap
    return best or most or "(no host operation traced)"


class Summary:
    """What one trace holds, in seconds."""

    def __init__(self, events: List[dict], window_s: float):
        self.window_s = window_s
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and "dur" in e]
        self.device = [(e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
                        e.get("name", "?"), e["cat"]) for e in dev]
        self.host = [(e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
                      e.get("name", "?")) for e in events
                     if e.get("cat") in HOST_CATS and "dur" in e]
        self.busy_s = union_seconds([(s, e) for s, e, _, _ in self.device])

    def kernels(self) -> List[Tuple[float, float, str]]:
        return [(s, e, n) for s, e, n, c in self.device if c == "kernel"]

    def time_matching(self, patterns: Sequence[str]) -> float:
        return sum(e - s for s, e, n in self.kernels()
                   if any(p in n for p in patterns))

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for s, e, name, _ in self.device:
            by[name[:NAME_CHARS]] = by.get(name[:NAME_CHARS], 0.0) + e - s
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        busy = merged([(s, e) for s, e, _, _ in self.device])
        if not busy:
            return []
        host = sorted(self.host)
        lo = min([busy[0][0]] + [h[0] for h in host])
        hi = max([busy[-1][1]] + [h[1] for h in host])
        gaps = [(lo, busy[0][0])] + [(busy[i][1], busy[i + 1][0])
                                     for i in range(len(busy) - 1)]
        gaps.append((busy[-1][1], hi))
        gaps = sorted((g for g in gaps if g[1] > g[0]),
                      key=lambda g: g[0] - g[1])[:n]
        return [[gap_label(g, host)[:NAME_CHARS], g[1] - g[0]]
                for g in gaps]


class Tracer:
    """Starts and stops the profiler around a steady part of the window:
    ``begin`` at ``start_s`` into the window, ``end`` ``length_s`` later."""

    def __init__(self, path: Path, start_s: float, length_s: float):
        self.path = Path(path)
        self.start_s, self.length_s = start_s, length_s
        self.prof = None
        self.t0: Optional[float] = None
        self.window_s: Optional[float] = None
        self.items = 0

    @property
    def on(self) -> bool:
        return self.prof is not None and self.window_s is None

    @property
    def done(self) -> bool:
        return self.window_s is not None

    def tick(self, elapsed: float, sync) -> None:
        """Called between two items of work; starts or stops the trace."""
        if self.done:
            return
        if not self.on and elapsed >= self.start_s:
            from torch.profiler import ProfilerActivity, profile

            sync()
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.t0 = time.perf_counter()
        elif self.on and elapsed >= self.start_s + self.length_s:
            self.stop(sync)

    def count(self, n: int) -> None:
        if self.on:
            self.items += n

    def stop(self, sync) -> None:
        if self.on and not self.done:
            sync()
            self.window_s = time.perf_counter() - self.t0
            self.prof.stop()

    def summary(self) -> Optional[Summary]:
        if self.prof is None or self.window_s is None:
            return None
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        self.prof = None
        gc.collect()
        with open(self.path) as f:
            events = json.load(f).get("traceEvents", [])
        return Summary(events, self.window_s)
