"""Share of the traced window of an eval run in which the device ran
nothing while the evaluators took a batch's detections (the program's
span ``phase.add_batch``), less the collector's full passes that fell in
it (``gc_idle_share.eval``)."""

from perfbench import program_spans

UNIT = "%"
LAYER = "evaluation (Model.get_detections, evaluation.coco.Evaluator)"
MOVES = "eval_images_per_s"


def read(rec):
    return program_spans.idle_share(rec, "eval", ["phase.add_batch"])
