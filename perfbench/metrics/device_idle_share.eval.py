"""Share of the traced window of a eval run in which the device ran
nothing, from the profiler's trace."""

from perfbench import readers

UNIT = "%"
LAYER = "device (H100)"
MOVES = "eval_images_per_s"


def read(rec):
    return readers.idle_share(rec, "eval")
