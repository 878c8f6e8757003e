"""Share of the traced device busy time of a train run spent in the
train-mode BatchNorm kernels that perfbench/kernels/batchnorm/ names
(cuDNN's pair, or cuDNN's forward and the port's backward kernels where it
runs them), forward and backward; the layer's statistics (torch.var_mean, a
reduction kernel of ATen's that other ops share) are left out."""

UNIT = "%"
LAYER = "compiled step (uda.base.Model.step under utils.graphs.StepGraphs)"
MOVES = "train_images_per_s"


def read(rec):
    s = rec.get("summary")
    if rec.get("entry") != "train" or s is None or s.busy_s <= 0:
        return None
    spent = s.time_matching(rec["kernel_family"]("batchnorm"))
    return 100.0 * spent / s.busy_s if spent > 0 else None
