"""Kernels launched in the traced window of a train run per image (an
exact count: a replayed graph's kernels are traced one by one)."""

from perfbench import readers

UNIT = "kernels"
LAYER = "compiled step (uda.base.Model.step under utils.graphs.StepGraphs)"
MOVES = "train_images_per_s"


def read(rec):
    return readers.launches_per_item(rec, "train")
