"""The readers' arithmetic: the union of device intervals, the tail over
all calls, the DCN layer's operations and bytes, the model's FLOPs."""

import pytest

from perfbench import counts, entries, readers
from perfbench.check import make_net
from perfbench.trace import Summary, gap_label, union_seconds

DLA = {"heads": {"hm": 6, "wh": 2, "reg": 2}, "head_conv": 256,
       "levels": [1, 1, 1, 2, 2, 1], "channels": [16, 32, 64, 128, 256, 512],
       "down_ratio": 4}
H100 = counts.peaks_for("NVIDIA H100 80GB HBM3")


def kernel(ts, dur, name="k"):
    return {"cat": "kernel", "ts": ts, "dur": dur, "name": name}


def test_union_counts_overlap_once():
    assert union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert union_seconds([(0, 10), (2, 3), (4, 5)]) == 10
    assert union_seconds([]) == 0


def test_idle_share_cannot_pass_100_with_overlapping_kernels():
    # three overlapping kernels, 3.0 s of kernel time in a 2.5 s window:
    # a sum would read busy 120 %, the union reads 80 %
    events = [kernel(0, 1e6), kernel(0.5e6, 1e6), kernel(1e6, 1e6)]
    s = Summary(events, 2.5)
    assert s.busy_s == pytest.approx(2.0)
    rec = {"entry": "train", "summary": s}
    assert readers.idle_share(rec, "train") == pytest.approx(20.0)
    assert readers.idle_share(rec, "eval") is None


def test_idle_gaps_are_named_by_the_host():
    events = [kernel(0, 1e6), kernel(3e6, 1e6),
              {"cat": "user_annotation", "ts": 0.9e6, "dur": 2.2e6,
               "name": "perfbench.evaluator.add_batch"},
              {"cat": "cpu_op", "ts": 1.5e6, "dur": 0.1e6, "name": "aten::x"}]
    gaps = Summary(events, 4.0).idle_gaps()
    assert gaps[0] == ["perfbench.evaluator.add_batch", pytest.approx(2.0)]
    assert gap_label((0, 1), []) == "(no host operation traced)"


def test_p95_is_over_all_calls():
    assert entries.p95([float(v) for v in range(1, 101)]) == 95.0
    assert entries.p95([float(v) for v in range(20, 0, -1)]) == 19.0
    assert entries.p95([3.0]) == 3.0


def test_dcn_layer_cost_by_hand():
    # B 2, Cin 4, 3 x 5 map, Cout 6: 30 positions
    ops, nbytes = counts.dcn_layer_cost((2, 4, 3, 5, 6), backward=False)
    assert ops == 2 * 30 * 6 * 9 * 4 == 12960
    # x 120, offsets 540, mask 270, weight 216, bias 6, out 180, float32
    assert nbytes == 4 * (120 + 540 + 270 + 216 + 6 + 180) == 5328
    ops, nbytes = counts.dcn_layer_cost((2, 4, 3, 5, 6), backward=True)
    assert ops == 2 * 12960
    # in: dout 180, x, offsets, mask, weight; out: their gradients, dbias
    assert nbytes == 4 * ((180 + 120 + 540 + 270 + 216)
                          + (120 + 540 + 270 + 216 + 6)) == 9912


def test_dla34_counts_at_512():
    net = make_net(DLA)
    shapes = counts.dcn_shapes(net, 16, 512)
    assert len(shapes) == 16
    fwd = counts.least_seconds(shapes, False, H100)
    both = counts.least_seconds(shapes, True, H100)
    # the bounds PERF.md's kernel table gives rows 1 and 3 at this shape
    assert fwd * 1e3 == pytest.approx(0.412, abs=5e-4)
    assert (both - fwd) * 1e3 == pytest.approx(0.692, abs=5e-4)
    # the port's utils/flops.py count: 65.579 GFLOP an image
    assert counts.forward_flops(net, 512) == 65578729472


def test_roofline_and_mfu_need_a_reading():
    s = Summary([kernel(0, 2e6, "void dcn_sample_fwd_kernel<1>(int)"),
                 kernel(2e6, 1e6, "other")], 4.0)
    rec = {"entry": "eval", "summary": s, "items": 10,
           "flops_per_item": 1e12, "peak_flops": 5e12,
           "dcn_least_s_per_item": 0.05,
           "kernel_family": lambda f: ["dcn_sample_fwd_kernel"]}
    assert readers.roofline(rec, "eval", "dcn") == pytest.approx(25.0)
    assert readers.mfu(rec, "eval") == pytest.approx(50.0)
    assert readers.roofline({**rec, "kernel_family": lambda f: ["x"]},
                            "eval", "dcn") is None
    assert readers.mfu({**rec, "peak_flops": None}, "eval") is None
    assert readers.launches_per_item(rec, "eval") == pytest.approx(0.2)
