"""Share of the traced window of an eval run in which the device ran
nothing while the detections were decoded and read to the host (the
program's span ``phase.detections``, with ``detections.to_host`` in it)."""

from perfbench import program_spans

UNIT = "%"
LAYER = "evaluation (Model.get_detections, evaluation.coco.Evaluator)"
MOVES = "eval_images_per_s"


def read(rec):
    return program_spans.idle_share(rec, "eval", ["phase.detections"])
