"""The DCN layers' least time (perfbench/counts.py) in a serve run over the
device time of the kernels that perfbench/kernels/dcn/ names."""

from perfbench import readers

UNIT = "%"
LAYER = "DCN (ops.dcn, ops.dcn_cuda, csrc/dcn_*.cu)"
MOVES = "serve_ms_p95"


def read(rec):
    return readers.roofline(rec, "serve", "dcn")
