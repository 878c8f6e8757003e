"""What the program's own spans say in a traced window.

The port marks its layers with host spans (``centernet_uda_torch/utils/
spans.py``): ``user_annotation`` events in the same profiler trace as the
device's operations, so on the same clock. They are told from ATen ops
and from the benchmark's own spans (``perfbench.*``) by name: a program
span's name starts with ``phase.``, ``graphs.``, ``detections.`` or
``gc.``.

Idle is counted only between the trace's first device operation and its
last: the gap after the profiler's opening synchronisation and the one
before its closing one are the harness's, whatever span the program was
in. The collector's full passes (``gc.full``) stop the host wherever an
allocation sets them off; their idle is their own (``GC``), and no other
span's.

Each function returns None where the trace holds no span of the names
asked for, as ``readers.py`` does: a program that emits no span (a parent
commit without them) reports nothing, never 0.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from perfbench.trace import merged

PREFIXES = ("phase.", "graphs.", "detections.", "gc.")

# the phase loop's own spans (``train._run_phase``): waiting for a batch,
# handing it to the compiled step, reading the stats to the host
LOOP = ("phase.batch_wait", "phase.step", "phase.stats_flush")

# the cyclic collector's full passes
GC = ("gc.full",)


def spans(summary, names: Iterable[str]) -> List[Tuple[float, float]]:
    """(start, end) of the trace's program spans named in ``names``."""
    names = {n for n in names if n.startswith(PREFIXES)}
    return [(s, e) for s, e, n in summary.host if n in names]


def _overlap(under: Sequence[Tuple[float, float]],
             cover: Sequence[Tuple[float, float]]) -> float:
    """Seconds of the merged intervals ``under`` that the merged
    intervals ``cover`` hold."""
    total, i = 0.0, 0
    for s, e in under:
        while i < len(cover) and cover[i][1] <= s:
            i += 1
        j = i
        while j < len(cover) and cover[j][0] < e:
            total += min(e, cover[j][1]) - max(s, cover[j][0])
            j += 1
    return total


def idle_under(summary, names: Iterable[str],
               without: Iterable[str] = GC) -> Optional[float]:
    """Seconds in which the spans named in ``names`` ran on the host and
    the device ran nothing, between the trace's first device operation and
    its last: the union of the spans (overlapping and nested ones count
    once) less the device-busy union and the spans named in ``without``
    inside it."""
    found = spans(summary, names)
    if not found:
        return None
    busy = merged([(s, e) for s, e, _, _ in summary.device])
    if not busy:
        return 0.0
    lo, hi = busy[0][0], busy[-1][1]
    under = merged([(max(s, lo), min(e, hi)) for s, e in found
                    if min(e, hi) > max(s, lo)])
    cover = merged(busy + spans(summary, without))
    return sum(e - s for s, e in under) - _overlap(under, cover)


def idle_share(rec: dict, entry: str, names: Iterable[str],
               without: Iterable[str] = GC) -> Optional[float]:
    """``idle_under`` as a percent of a traced run's window, for a run of
    ``entry`` only."""
    s = rec.get("summary")
    if (rec.get("entry") != entry or s is None or s.window_s <= 0
            or not s.device):
        return None
    idle = idle_under(s, names, without)
    return None if idle is None else 100.0 * idle / s.window_s


def gc_share(rec: dict, entry: str) -> Optional[float]:
    """The share of the window in which the device idled under the
    collector's full passes: 0 where the program marks its phase loop and
    no pass fell in the window, None where it marks no loop."""
    if idle_share(rec, entry, LOOP) is None:
        return None
    return idle_share(rec, entry, GC, without=()) or 0.0
