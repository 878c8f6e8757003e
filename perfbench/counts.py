"""The benchmark's own counts: model FLOPs, DCN operations and bytes, and
the table of peaks (``perfbench/peaks.json``).

Model FLOPs of one image's forward are counted on the configuration's
reference net (``perfbench/reference/<net>.py``) on the ``meta`` device
under ``torch.utils.flop_counter.FlopCounterMode``: convolutions
(transposed ones at their input positions), matrix products, each
multiply-add as 2. DLA-34's DCN layers' contraction is the reference's
``matmul``, their offset convs are convolutions; sampling, BatchNorm,
activations and decode are not counted. A train step costs three forwards
(forward, and the backward's two products); a UDA step runs both domains.
The DCN layers' shapes are those the net records in its ``dcn_shapes``
(none for a net without DCN).

A DCN layer's least work (``dcn_layer_cost``), counted from its shape
(B, Cin, H, W, Cout), 3x3, stride 1: its operations are the contraction's,
2 B H W Cout 9 Cin (the forward; the backward twice that, for dW and the
sample gradient), and its bytes each input read once and each output
written once, in float32: forward x, offsets (18 channels), mask (9),
weight and bias in, the output out; backward the output's gradient, x,
offsets, mask and weight in, the gradients of x, offsets, mask, weight and
bias out.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"
F32 = 4


def forward_flops(net, size: int) -> int:
    """FLOPs of one ``size`` x ``size`` image's forward (eval mode)."""
    weights = {n: torch.zeros(s, device="meta", dtype=torch.long
                              if k == "count" else torch.float32)
               for n, s, k in net.spec()}
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        net.forward(weights, torch.zeros(1, 3, size, size, device="meta"),
                    mode="eval")
    return int(counter.get_total_flops())


def dcn_shapes(net, batch: int, size: int
               ) -> List[Tuple[int, int, int, int, int]]:
    """(B, Cin, H, W, Cout) of each DCN layer of one forward."""
    weights = {n: torch.zeros(s, device="meta", dtype=torch.long
                              if k == "count" else torch.float32)
               for n, s, k in net.spec()}
    net.dcn_shapes = []
    try:
        with torch.no_grad():
            net.forward(weights, torch.zeros(batch, 3, size, size,
                                             device="meta"), mode="eval")
        return list(net.dcn_shapes)
    finally:
        net.dcn_shapes = None


def dcn_layer_cost(shape, backward: bool) -> Tuple[int, int]:
    """(operations, bytes) of one DCN layer's forward or backward."""
    b, cin, h, w, cout = shape
    hw = b * h * w
    contraction = 2 * hw * cout * 9 * cin
    x, off, mask, out = hw * cin, hw * 18, hw * 9, hw * cout
    weight, bias = cout * cin * 9, cout
    if not backward:
        return contraction, F32 * (x + off + mask + weight + bias + out)
    reads = out + x + off + mask + weight
    writes = x + off + mask + weight + bias
    return 2 * contraction, F32 * (reads + writes)


def least_seconds(shapes, backward: bool, peaks: Dict[str, float]) -> float:
    """The least time the chip could take for these layers: per layer the
    larger of operations over the bf16 tensor-core peak (the kernels'
    products are bf16) and bytes over the memory bandwidth."""
    total = 0.0
    for shape in shapes:
        ops, nbytes = dcn_layer_cost(shape, False)
        total += max(ops / peaks["bf16_flops"],
                     nbytes / peaks["hbm_bytes_per_s"])
        if backward:
            ops, nbytes = dcn_layer_cost(shape, True)
            total += max(ops / peaks["bf16_flops"],
                         nbytes / peaks["hbm_bytes_per_s"])
    return total


def peaks_for(device_name: str) -> Optional[Dict[str, float]]:
    """The published peaks of the named card, or None if the table does
    not hold it."""
    table = json.loads(PEAKS_FILE.read_text())
    return table.get(device_name)
