"""Model FLOPs of the serve work traced over the window, as a share of the
card's peak in the configuration's precision."""

from perfbench import readers

UNIT = "%"
LAYER = "served program (export.load_artifact)"
MOVES = "serve_ms_p95"


def read(rec):
    return readers.mfu(rec, "serve")
