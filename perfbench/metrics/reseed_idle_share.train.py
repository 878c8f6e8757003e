"""Share of the traced window of a train run in which the device ran
nothing while the host reseeded the train step's stochastic-depth
generator (the program's span ``graphs.reseed``, once a step, inside
``phase.step``)."""

from perfbench import program_spans

UNIT = "%"
LAYER = "compiled step (uda.base.Model.step under utils.graphs.StepGraphs)"
MOVES = "train_images_per_s"


def read(rec):
    return program_spans.idle_share(rec, "train", ["graphs.reseed"])
