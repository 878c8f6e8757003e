"""The DCN layers' least time (perfbench/counts.py) in a train run over the
device time of the kernels that perfbench/kernels/dcn/ names."""

from perfbench import readers

UNIT = "%"
LAYER = "DCN (ops.dcn, ops.dcn_cuda, csrc/dcn_*.cu)"
MOVES = "train_images_per_s"


def read(rec):
    return readers.roofline(rec, "train", "dcn")
