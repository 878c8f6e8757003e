"""Kernels launched per served call in the traced window (an exact count)."""

from perfbench import readers

UNIT = "launches"
LAYER = "served program (export.load_artifact)"
MOVES = "serve_ms_p95"


def read(rec):
    return readers.launches_per_item(rec, "serve")
