"""Host milliseconds of the evaluator's add_batch per eval batch, from the
benchmark's span around it."""

from perfbench import readers

UNIT = "ms"
LAYER = "evaluation (Model.get_detections, evaluation.coco.Evaluator)"
MOVES = "eval_images_per_s"


def read(rec):
    return readers.span_ms(rec, "eval", "evaluator.add_batch")
