"""Share of the traced window of an eval run in which the device ran
nothing while the host ran a full pass of Python's cyclic collector (the
program's span ``gc.full``); 0 where no pass fell in the window."""

from perfbench import program_spans

UNIT = "%"
LAYER = "host runtime (Python's cyclic collector)"
MOVES = "eval_images_per_s"


def read(rec):
    return program_spans.gc_share(rec, "eval")
