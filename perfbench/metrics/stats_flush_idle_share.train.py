"""Share of the traced window of a train run in which the device ran
nothing while the port's phase loop read the queued steps' stats to the
host (the program's span ``phase.stats_flush``, every 8 train steps)."""

from perfbench import program_spans

UNIT = "%"
LAYER = "phase loop (train._run_phase)"
MOVES = "train_images_per_s"


def read(rec):
    return program_spans.idle_share(rec, "train", ["phase.stats_flush"])
