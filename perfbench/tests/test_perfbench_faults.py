"""A whole run, on the CPU, with the timed path broken underneath: each
fault a cell can have must turn ``correct`` false, and a sound run must
not.

The run skips the look for a card and drives everything else of
``harness.run_cell``: the entry, the window, the reference, the judgement
against the cell's limits. The port runs its CPU path with the kernels'
arithmetic (``dcn_impl=cuda``: the DCN twin) at 64 px (128 px served),
one image a batch (two where half of one is left out).

On the card the window replays a captured train step. ``StandIn`` gives
the CPU trainer compiled steps through a stand-in for the CUDA graph, so
that a fault can be planted in the replay alone, the eager call and the
capture left sound.
"""

import numpy as np
import pytest
import torch

from centernet_uda_torch.ops import decode as decode_lib
from centernet_uda_torch.utils.graphs import StepGraphs, map_tensors
from perfbench import harness

SEED = 2 ** 33 + 101
SMALL = {"input_size": 64, "batch": 1, "objects": [2, 4], "box_px": [8, 24]}


def run(workload, patch=None, **mix):
    return harness.run_cell(workload, SEED, 0.5, False, device="cpu",
                            overrides=["dcn_impl=cuda"],
                            mix_overrides={**SMALL, **mix}, patch=patch,
                            emit=False)


def unchanged_state(trainer):
    trainer.optimizer.step = lambda *args, **kwargs: None


def half_batch(trainer):
    inner = trainer.loss_terms

    def loss_terms(batch, train):
        n = batch["input"].shape[0] // 2
        return inner({k: v[:n] if isinstance(v, torch.Tensor) else v
                      for k, v in batch.items()}, train)

    trainer.loss_terms = loss_terms


def altered_detection(trainer):
    inner = trainer.get_detections

    def get_detections(outputs, batch):
        dets = inner(outputs, batch)
        dets["pred_scores"] = np.array(dets["pred_scores"], copy=True)
        dets["pred_scores"][0, 0] += 0.05
        return dets

    trainer.get_detections = get_detections


def altered_served(module):
    def served(x):
        boxes, scores, classes = module(x)
        scores = scores.clone()
        scores[0, 0] += 0.05
        return boxes, scores, classes

    return served


class StandIn:
    """A CUDA graph's behaviour on the CPU: capture runs the step once and
    puts back every state tensor it changed (a real capture records and
    runs nothing), a replay runs the step again on the static inputs and
    writes its results into the captured outputs. ``fault`` breaks the
    replay alone: ``unchanged`` runs nothing (the state stays as it is),
    ``half`` runs the step on the first half of the batch."""

    replaying = False

    def __init__(self, trainer, fault=None):
        self.trainer, self.fault = trainer, fault
        self.fn = self.outputs = None

    def state(self):
        tensors = list(self.trainer.backend.module.parameters())
        tensors += list(self.trainer.backend.module.buffers())
        for st in self.trainer.optimizer.state.values():
            tensors += [v for v in st.values() if isinstance(v, torch.Tensor)]
        return tensors

    def capture(self, fn):
        tensors = self.state()
        saved = [t.detach().clone() for t in tensors]
        self.fn = fn
        self.outputs = fn()
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)
        return self.outputs

    def replay(self):
        if self.fault == "unchanged":
            return
        StandIn.replaying = self.fault == "half"
        try:
            new = []
            map_tensors(new.append, self.fn())
        finally:
            StandIn.replaying = False
        old = []
        map_tensors(old.append, self.outputs)
        with torch.no_grad():
            for dst, src in zip(old, new):
                dst.copy_(src)


def graphed(fault=None):
    def patch(trainer):
        trainer.step_graphs = StepGraphs(
            "cpu", graph_factory=lambda generators: StandIn(trainer, fault),
            counters={})
        if fault == "half":
            inner = trainer.loss_terms

            def loss_terms(batch, train):
                if StandIn.replaying:
                    n = batch["input"].shape[0] // 2
                    batch = {k: v[:n] if isinstance(v, torch.Tensor) else v
                             for k, v in batch.items()}
                return inner(batch, train)

            trainer.loss_terms = loss_terms
    return patch


def no_suppression(monkeypatch):
    """The decode's 3x3 peak suppression left out: every position is a
    peak."""
    monkeypatch.setattr(decode_lib, "nms_peaks", lambda heat, kernel=3: heat)


@pytest.mark.parametrize("workload", ["dla34_baseline.train_512",
                                      "dla34_entmin.train_512"])
def test_train_faults(workload):
    assert run(workload)["correct"]
    assert not run(workload, unchanged_state)["correct"]
    assert not run(workload, half_batch, batch=2)["correct"]


@pytest.mark.parametrize("workload", ["dla34_baseline.train_512",
                                      "dla34_entmin.train_512"])
def test_train_faults_in_the_replay_alone(workload):
    assert run(workload, graphed(), batch=2)["correct"]
    assert not run(workload, graphed("unchanged"), batch=2)["correct"]
    assert not run(workload, graphed("half"), batch=2)["correct"]


def test_eval_faults(monkeypatch):
    assert run("dla34_baseline.eval_800")["correct"]
    assert not run("dla34_baseline.eval_800", altered_detection)["correct"]
    assert not run("dla34_baseline.eval_800", half_batch, batch=2)["correct"]
    no_suppression(monkeypatch)
    assert not run("dla34_baseline.eval_800")["correct"]


def test_serve_fault(monkeypatch):
    # the served cell waits outside BENCHMARK.json (perfbench/waiting/)
    bench = harness.with_waiting(harness.spec())
    monkeypatch.setattr(harness, "spec", lambda: bench)
    # 128 px: the served k = 150 needs more peaks than a 16 x 16 map has
    assert run("dla34_baseline.serve_b1", input_size=128)["correct"]
    assert not run("dla34_baseline.serve_b1", altered_served,
                   input_size=128)["correct"]
    no_suppression(monkeypatch)
    assert not run("dla34_baseline.serve_b1", input_size=128)["correct"]
