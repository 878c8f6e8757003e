"""The port's host spans (``centernet_uda_torch/utils/spans.py``) on the
CPU: off, a span is one shared no-op context and never a
``record_function``, while its ``totals`` still add up; under a profiler,
the phase loop, the compiled step (through the stand-in graph of
``tests/torch_graph_stand_in.py``) and the evaluation mark the trace, in
the places ``train._run_phase``'s record counts; a train step with a
stochastic-depth generator marks its reseed (``graphs.reseed``) inside
its ``phase.step``, one without marks none; the cyclic collector's full
passes are ``gc.full`` spans under a profiler.
"""

import gc
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from centernet_uda_torch import evaluation
from centernet_uda_torch.config import compose
from centernet_uda_torch.train import _run_phase, build_trainer
from centernet_uda_torch.utils import spans
from tests import test_torch_slice as sl
from tests.test_torch_step_graphs import small_trainer
from tests.torch_graph_stand_in import stand_in_graphs

torch.set_num_threads(2)

PHASE = ("phase.batch_wait", "phase.step", "phase.stats_flush",
         "phase.detections", "phase.add_batch")
RECORD = {"epoch", "tag", "steps", "images", "seconds", "loader_wait_s",
          "log_detections_s", "total_loss", "graph_calls"}
GRAPHS = {"graphs.eager": "eager", "graphs.capture": "captures",
          "graphs.replay": "replays"}


@pytest.fixture
def counted_record_function(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counting(name, *args):
        made.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return made


def test_off_a_span_is_no_record_function_and_totals_add_up(
        counted_record_function):
    assert not spans.recording()
    totals = {}
    for _ in range(3):
        with spans.span("phase.step", totals):
            pass
        with spans.span("graphs.replay"):
            pass
    with pytest.raises(StopIteration):
        with spans.span("phase.batch_wait", totals):
            next(iter([]))
    assert counted_record_function == []
    # one shared context where no totals are kept
    assert spans.span("a") is spans.span("b")
    assert set(totals) == {"phase.step"} and totals["phase.step"] > 0


def test_on_a_span_is_a_record_function(counted_record_function):
    totals = {}
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.recording()
        with spans.span("phase.step", totals):
            pass
        with spans.span("graphs.replay"):
            pass
    assert counted_record_function == ["phase.step", "graphs.replay"]
    assert totals["phase.step"] > 0


def events(path):
    with open(path) as f:
        trace = json.load(f)["traceEvents"]
    return [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in trace
            if e.get("cat") == "user_annotation" and "dur" in e]


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def named(evs, name, within=None):
    return [e for e in evs if e[2] == name
            and (within is None or inside(e, within))]


def test_phase_loop_and_compiled_step_mark_the_trace(tmp_path):
    trainer = small_trainer()
    stand_in_graphs(trainer)
    evaluator = evaluation.build("coco", per_class=True,
                                 score_threshold=0.0)
    phases = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.training"):
            _run_phase(trainer, [sl.make_batch(i) for i in range(3)], [],
                       None, {}, 1, "training", True, phases)
        with torch.profiler.record_function("test.validation"):
            _run_phase(trainer, [sl.make_batch(7), sl.make_batch(8)],
                       [evaluator], None, {}, 1, "validation", False,
                       phases)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    evs = events(path)
    names = {e[2] for e in evs}
    assert set(PHASE) | {"detections.to_host"} | set(GRAPHS) <= names

    train, valid = phases
    [t_phase] = named(evs, "test.training")
    [v_phase] = named(evs, "test.validation")
    # the train step's graph: the eager call, the capture (and its
    # replay), a replay, every one inside the loop's phase.step
    assert train["graph_calls"] == {"eager": 1, "captures": 1, "replays": 2}
    # the eval and decode graphs: each eager, then captured and replayed
    assert valid["graph_calls"] == {"eager": 2, "captures": 2, "replays": 2}
    for rec, phase in ((train, t_phase), (valid, v_phase)):
        steps = named(evs, "phase.step", phase)
        assert len(steps) == rec["steps"]
        for span_name, key in GRAPHS.items():
            found = named(evs, span_name, phase)
            assert len(found) == rec["graph_calls"][key], span_name
        # the eval and train steps' graph calls lie inside a phase.step,
        # the decode's inside a phase.detections
        holders = steps + named(evs, "phase.detections", phase)
        for g in (e for e in evs if e[2].startswith("graphs.")
                  and inside(e, phase)):
            assert any(inside(g, h) for h in holders), g
    for name in ("graphs.eager", "graphs.capture", "graphs.replay"):
        in_steps = [g for g in named(evs, name, v_phase)
                    if any(inside(g, s) for s in
                           named(evs, "phase.step", v_phase))]
        # one of the two in each holder: the eval step's and the decode's
        assert len(in_steps) == len(named(evs, name, v_phase)) // 2
    # the detections' read to the host, inside phase.detections; the
    # evaluator's add_batch once an eval batch
    dets = named(evs, "phase.detections")
    to_host = named(evs, "detections.to_host")
    assert len(dets) == len(to_host) == 2
    assert all(any(inside(t, d) for d in dets) for t in to_host)
    assert len(named(evs, "phase.add_batch", v_phase)) == 2
    assert named(evs, "phase.detections", t_phase) == []
    # a flush every eval step, one at the train phase's end (3 < 8 steps)
    assert len(named(evs, "phase.stats_flush", t_phase)) == 1
    assert len(named(evs, "phase.stats_flush", v_phase)) == 3

    # the record's host times are the spans' own: the loader wait is
    # the phase.batch_wait events' time less the profiler's own, and no
    # other time went into the record
    for rec, phase in ((train, t_phase), (valid, v_phase)):
        waits = named(evs, "phase.batch_wait", phase)
        # one a step, and the last, which finds the loader's end
        assert len(waits) == rec["steps"] + 1
        assert 0 < rec["loader_wait_s"] <= 1e-6 * sum(e - s
                                                      for s, e, _ in waits)
        assert rec["log_detections_s"] == 0.0
    assert set(train) == RECORD
    assert set(valid) == RECORD


def test_the_stochastic_depth_reseed_is_a_span_of_each_train_step(tmp_path):
    """EfficientNet-b0 at 32 px, two train steps: one ``graphs.reseed``
    a step, inside its ``phase.step``; DLA-34, which draws nothing per
    step, marks none."""
    from tests import test_torch_efficientnet_trainer as ek

    effnet = build_trainer(compose(ek.OVERRIDES), device="cpu")
    effnet.init_done()
    assert effnet.drop_generator is not None
    dla = small_trainer(graphs=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.effnet"):
            _run_phase(effnet, [ek.make_batch(i, 32) for i in range(2)], [],
                       None, {}, 1, "training", True, [])
        with torch.profiler.record_function("test.dla"):
            _run_phase(dla, [sl.make_batch(0)], [], None, {}, 1, "training",
                       True, [])
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    evs = events(path)
    [e_phase] = named(evs, "test.effnet")
    [d_phase] = named(evs, "test.dla")
    steps = named(evs, "phase.step", e_phase)
    reseeds = named(evs, "graphs.reseed", e_phase)
    assert len(steps) == len(reseeds) == 2
    assert all(any(inside(r, s) for s in steps) for r in reseeds)
    assert len(named(evs, "phase.step", d_phase)) == 1
    assert named(evs, "graphs.reseed", d_phase) == []


def test_a_full_collection_is_a_span_only_while_a_profiler_records(
        counted_record_function, tmp_path):
    gc.collect()
    gc.collect(1)
    assert counted_record_function == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gc.collect(1)
        gc.collect()
    assert counted_record_function == ["gc.full"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    assert [e[2] for e in events(path)] == ["gc.full"]
    assert spans._gc_open == []
