"""Model FLOPs of the eval work traced over the window, as a share of the
card's peak in the configuration's precision."""

from perfbench import readers

UNIT = "%"
LAYER = "compiled step (uda.base.Model.step under utils.graphs.StepGraphs)"
MOVES = "eval_images_per_s"


def read(rec):
    return readers.mfu(rec, "eval")
