"""Share of the traced window of an eval run in which the device ran
nothing while the port's phase loop waited for a batch, handed a step
over or read its stats (the program's spans ``phase.batch_wait``,
``phase.step``, ``phase.stats_flush``)."""

from perfbench import program_spans

UNIT = "%"
LAYER = "phase loop (train._run_phase)"
MOVES = "eval_images_per_s"


def read(rec):
    return program_spans.idle_share(rec, "eval", program_spans.LOOP)
