"""Shared arithmetic of the per-layer readers (``perfbench/metrics/``).

Each reader gets the record of a traced run (``harness.layer_records``)
and returns its number, or None where the run has nothing for it to read
(another entry, no trace, a card the table of peaks does not hold, no
kernel of the family in the trace). None leaves the metric out of the
line; a share is never reported as 0 for want of a reading.
"""

from __future__ import annotations

from typing import Optional


def _traced(rec: dict, entry: str):
    s = rec.get("summary")
    if (rec.get("entry") != entry or s is None or s.window_s <= 0
            or not s.device):
        return None
    return s


def idle_share(rec: dict, entry: str) -> Optional[float]:
    """Percent of the traced window in which no operation ran on the
    device: 1 - union of device intervals / window."""
    s = _traced(rec, entry)
    return None if s is None else 100.0 * (1.0 - s.busy_s / s.window_s)


def mfu(rec: dict, entry: str) -> Optional[float]:
    """Model FLOPs of the work traced (images, or calls, times the
    benchmark's count of one) over the window, as a percent of the card's
    peak in the configuration's precision."""
    s = _traced(rec, entry)
    if s is None or rec.get("peak_flops") is None or not rec.get("items"):
        return None
    return 100.0 * rec["items"] * rec["flops_per_item"] / s.window_s \
        / rec["peak_flops"]


def roofline(rec: dict, entry: str, family: str) -> Optional[float]:
    """Percent of the least time of the traced work's layers of this
    family (``dcn_least_s_per_item`` times the items) in the device time
    of the kernels the family names."""
    s = _traced(rec, entry)
    least = rec.get("dcn_least_s_per_item")
    if s is None or least is None or not rec.get("items"):
        return None
    spent = s.time_matching(rec["kernel_family"](family))
    if spent <= 0:
        return None
    return 100.0 * least * rec["items"] / spent


def span_ms(rec: dict, entry: str, span: str) -> Optional[float]:
    """Mean milliseconds of a benchmark span over the window."""
    if rec.get("entry") != entry:
        return None
    values = rec.get("spans", {}).get(span) or []
    return 1e3 * sum(values) / len(values) if values else None


def launches_per_item(rec: dict, entry: str) -> Optional[float]:
    """Kernels launched in the traced window per item of work."""
    s = _traced(rec, entry)
    if s is None or not rec.get("items"):
        return None
    return len(s.kernels()) / rec["items"]
