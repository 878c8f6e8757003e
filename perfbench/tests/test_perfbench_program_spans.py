"""The program spans' arithmetic (``perfbench/program_spans.py``) and the
five readers that use it, on hand-built traces."""

import pytest

from perfbench import harness, program_spans
from perfbench.trace import Summary

READERS = ("stats_flush_idle_share.train", "loop_idle_share.eval",
           "evaluator_idle_share.eval", "detections_idle_share.eval",
           "gc_idle_share.eval")


def kernel(ts, dur, name="k"):
    return {"cat": "kernel", "ts": ts, "dur": dur, "name": name}


def host(ts, dur, name, cat="user_annotation"):
    return {"cat": cat, "ts": ts, "dur": dur, "name": name}


def test_overlapping_and_nested_spans_count_once():
    # device work only at the trace's ends: the idle under the spans is
    # their union, 0-3 s and 4-5 s
    s = Summary([kernel(0, 1), kernel(6e6, 1),
                 host(0, 2e6, "phase.step"), host(1e6, 2e6, "phase.step"),
                 host(0.5e6, 0.5e6, "graphs.replay"),
                 host(4e6, 1e6, "phase.stats_flush")], 6.0)
    names = ["phase.step", "graphs.replay", "phase.stats_flush"]
    assert program_spans.idle_under(s, names) == pytest.approx(4.0)


def test_device_time_inside_a_span_is_taken_off():
    # span 1-5 s; kernels 0-2 and 3-3.5 and 3.2-4 (overlapping) and 6-7
    s = Summary([kernel(0, 2e6), kernel(3e6, 0.5e6), kernel(3.2e6, 0.8e6),
                 kernel(6e6, 1e6),
                 host(1e6, 4e6, "phase.add_batch")], 8.0)
    # 4 s of span, 1 s (1-2) and 1 s (3-4) of it busy
    assert program_spans.idle_under(s, ["phase.add_batch"]) == \
        pytest.approx(2.0)
    rec = {"entry": "eval", "summary": s}
    assert harness.load_reader("evaluator_idle_share.eval").read(rec) == \
        pytest.approx(25.0)
    # another entry's run has nothing for it
    assert harness.load_reader("stats_flush_idle_share.train").read(rec) \
        is None


def test_aten_ops_and_the_benchmarks_spans_are_not_taken():
    s = Summary([kernel(9e6, 1e6),
                 host(1e6, 1e6, "aten::phase.step", cat="cpu_op"),
                 host(2e6, 1e6, "phase.step_extra"),
                 host(3e6, 1e6, "perfbench.step"),
                 host(5e6, 1e6, "phase.step")], 10.0)
    assert program_spans.spans(s, ["phase.step"]) == [(5.0, 6.0)]
    assert program_spans.spans(s, ["perfbench.step", "aten::item"]) == []
    assert program_spans.idle_under(s, ["perfbench.step"]) is None


def test_a_trace_without_program_spans_reads_none():
    # a parent commit's trace: kernels, ATen ops and the benchmark's spans
    s = Summary([kernel(0, 1e6), kernel(2e6, 1e6),
                 host(0.5e6, 2e6, "perfbench.step"),
                 host(1e6, 1e6, "aten::item", cat="cpu_op")], 4.0)
    for entry in ("train", "eval"):
        rec = {"entry": entry, "summary": s}
        for name in READERS:
            assert harness.load_reader(name).read(rec) is None, name
    assert program_spans.idle_under(s, ["graphs.eager"]) is None


def test_the_readers_on_a_traced_step():
    # a train window of 10 s: a 0.5 s phase.step whose replay runs 1-9 s
    # on the device, a flush that waits 0.5-9.5 s; kernels 0-0.1 s and
    # 9.2-9.3 s
    events = [host(0, 0.5e6, "phase.batch_wait"),
              host(0.5e6, 0.5e6, "phase.step"),
              host(0.6e6, 0.3e6, "graphs.replay"),
              host(1e6, 8.5e6, "phase.stats_flush"),
              kernel(0, 0.1e6), kernel(1e6, 8e6), kernel(9.2e6, 0.1e6)]
    rec = {"entry": "train", "summary": Summary(events, 10.0)}
    # idle under the flush: 9-9.2 s (9.3-9.5 s is after the last device
    # operation)
    assert harness.load_reader("stats_flush_idle_share.train").read(rec) \
        == pytest.approx(2.0)
    # idle under the loop: 0.1-1 s and 9-9.2 s
    assert program_spans.idle_under(rec["summary"], program_spans.LOOP) \
        == pytest.approx(1.1)


def test_the_edges_of_the_trace_are_not_the_programs():
    # the profiler opens at 0 and closes at 10 s; the device runs 2-8 s
    # with a gap at 4-5 s; the spans cover all of it
    events = [kernel(2e6, 2e6), kernel(5e6, 3e6),
              host(0, 3e6, "phase.batch_wait"),
              host(3e6, 7e6, "phase.step")]
    s = Summary(events, 10.0)
    assert program_spans.idle_under(s, ["phase.batch_wait"]) == 0.0
    assert program_spans.idle_under(s, ["phase.step"]) == \
        pytest.approx(1.0)


def test_the_collectors_passes_are_their_own():
    # an eval window of 10 s, the device busy 0-2 s and 9-10 s; add_batch
    # 2-9 s holds a full pass 4-7 s, detections 1-3 s another at 2.5-3 s
    events = [kernel(0, 2e6), kernel(9e6, 1e6),
              host(0.5e6, 0.5e6, "phase.step"),
              host(1e6, 2e6, "phase.detections"),
              host(2.5e6, 0.5e6, "gc.full"),
              host(3e6, 6e6, "phase.add_batch"),
              host(4e6, 3e6, "gc.full")]
    rec = {"entry": "eval", "summary": Summary(events, 10.0)}
    read = {n: harness.load_reader(n).read(rec) for n in READERS[1:]}
    assert read == pytest.approx({
        "loop_idle_share.eval": 0.0, "evaluator_idle_share.eval": 30.0,
        "detections_idle_share.eval": 5.0, "gc_idle_share.eval": 35.0})
    # with no pass in the window the share is 0, not None
    rec["summary"] = Summary(events[:3] + events[5:6], 10.0)
    assert harness.load_reader("gc_idle_share.eval").read(rec) == 0.0
    # nor does a collector's span alone make a program that marks its loop
    rec["summary"] = Summary(events[:2] + events[4:5], 10.0)
    assert harness.load_reader("gc_idle_share.eval").read(rec) is None
