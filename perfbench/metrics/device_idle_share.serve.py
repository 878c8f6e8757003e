"""Share of the traced window of a serve run in which the device ran
nothing, from the profiler's trace."""

from perfbench import readers

UNIT = "%"
LAYER = "device (H100)"
MOVES = "serve_ms_p95"


def read(rec):
    return readers.idle_share(rec, "serve")
