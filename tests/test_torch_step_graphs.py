"""The compiled steps (``centernet_uda_torch/utils/graphs.py``) on the CPU.

A CUDA graph needs a card, so ``StepGraphs`` gets a stand-in for it here
(``StandInGraph``): capture runs the step once and puts back every state
tensor it changed (a real capture records and runs nothing), and a replay
runs the step again on the static inputs, writes its results into the
captured outputs and puts the launch counters back (a real replay runs no
Python). With it the helper's own logic runs as on the card: the first
call of a signature eager, the second capturing and replaying once, later
ones replaying; copies returned; invalidation; launch accounting.

Trajectories: a narrow DLA-34 at 64 px (``tests/test_torch_slice.py``'s
config, Adam at lr 1e-3) and ADVENT at 128 px
(``tests/test_torch_uda_twins.py``'s), 3 train steps on distinct seeded
batches, through the stand-in: bit for bit the eager port's trajectory
(same ops on the same values in the same order), and within 1e-3 relative
of the JAX package's jitted steps, the bound of
``test_torch_slice.py::test_loss_trajectory_matches_jax``.
"""

import numpy as np
import pytest
import torch

from centernet_uda_torch.config import compose
from centernet_uda_torch.ops.dcn import PALLAS_MAX_SHIFT
from centernet_uda_torch.train import build_trainer
from centernet_uda_torch.utils.graphs import StepGraphs, map_tensors
from tests import test_torch_slice as sl
from tests import test_torch_uda_twins as tw

torch.set_num_threads(2)


class StandInGraph:
    """A CUDA graph's behaviour on the CPU (see the module docstring).
    ``state()`` gives the tensors a step updates in place; ``counters`` the
    launch counters a replay must leave alone."""

    def __init__(self, state=lambda: (), counters=None):
        self.state = state
        self.counters = counters
        self.fn = self.outputs = None

    def capture(self, fn):
        tensors = list(self.state())
        saved = [t.detach().clone() for t in tensors]
        self.fn = fn
        self.outputs = fn()
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)
        return self.outputs

    def replay(self):
        counts = None if self.counters is None else dict(self.counters)
        new = iter(_leaves(self.fn()))
        for dst in _leaves(self.outputs):
            src = next(new)
            with torch.inference_mode(dst.is_inference()), torch.no_grad():
                dst.copy_(src)
        if counts is not None:
            self.counters.update(counts)


def _leaves(tree):
    out = []
    map_tensors(out.append, tree)
    return out


def state_of(trainer):
    """The tensors a train step updates in place: the backend's (and the
    discriminator's) parameters and buffers and the optimizers' state."""
    tensors = []
    modules = [trainer.backend.module, getattr(trainer, "discriminator",
                                               None)]
    optims = [trainer.optimizer, getattr(trainer, "disc_optimizer", None)]
    for m in filter(None, modules):
        tensors += list(m.parameters()) + list(m.buffers())
    for opt in filter(None, optims):
        for st in opt.state.values():
            tensors += [v for v in st.values() if isinstance(v, torch.Tensor)]
    return tensors


def stand_in_graphs(trainer, counters=None):
    """Give ``trainer`` compiled steps on the CPU, through the stand-in."""
    trainer.step_graphs = StepGraphs(
        "cpu", graph_factory=lambda: StandInGraph(lambda: state_of(trainer),
                                                  counters),
        counters={} if counters is None else counters)
    return trainer.step_graphs


# ---------------------------------------------------------------------------
# the helper


def test_first_call_eager_then_capture_then_replay_and_new_shapes():
    state = torch.zeros(())
    calls = []

    def fn(inputs):
        calls.append(tuple(inputs["x"].shape))
        state.add_(1)
        return {"y": inputs["x"] * 2 + state}

    graphs = StepGraphs("cpu", lambda: StandInGraph(lambda: [state]),
                        counters={})
    x = torch.arange(3.0)
    out = graphs("step", fn, {"x": x})
    assert graphs.calls == {"eager": 1, "captures": 0, "replays": 0}
    assert len(graphs) == 0 and state.item() == 1
    torch.testing.assert_close(out["y"], x * 2 + 1)
    out = graphs("step", fn, {"x": x + 1})
    # the capture's own run is undone: one step's worth of work
    assert graphs.calls == {"eager": 1, "captures": 1, "replays": 1}
    assert len(graphs) == 1 and state.item() == 2
    torch.testing.assert_close(out["y"], (x + 1) * 2 + 2)
    out = graphs("step", fn, {"x": x + 2})
    assert graphs.calls == {"eager": 1, "captures": 1, "replays": 2}
    torch.testing.assert_close(out["y"], (x + 2) * 2 + 3)
    # another shape is another signature: eager, then its own capture
    graphs("step", fn, {"x": torch.arange(4.0)})
    assert graphs.calls["eager"] == 2 and len(graphs) == 1
    graphs("step", fn, {"x": torch.arange(4.0)})
    assert graphs.calls["captures"] == 2 and len(graphs) == 2
    # so is another dtype, and another name
    graphs("step", fn, {"x": torch.arange(3, dtype=torch.float64)})
    graphs("other", fn, {"x": x})
    assert graphs.calls["eager"] == 4


def test_returned_outputs_outlive_the_next_call():
    def fn(inputs):
        return {"loss": inputs["x"].sum(), "parts": (inputs["x"] * 3,)}

    graphs = StepGraphs("cpu", StandInGraph, counters={})
    held = [graphs("step", fn, {"x": torch.full((2,), float(i))})
            for i in range(4)]
    for i, out in enumerate(held):
        assert out["loss"].item() == 2.0 * i
        torch.testing.assert_close(out["parts"][0], torch.full((2,), 3.0 * i))


def test_launch_accounting_adds_a_replay_exactly():
    counters = {"dcn_fwd": 0, "dcn_bwd": 0}

    def fn(inputs):
        # a wrapper counts where it launches: 3 forwards, 2 backwards a step
        counters["dcn_fwd"] += 3
        counters["dcn_bwd"] += 2
        return {"y": inputs["x"] + 1}

    graphs = StepGraphs("cpu", lambda: StandInGraph(counters=counters),
                        counters=counters)
    for step in range(1, 6):
        graphs("step", fn, {"x": torch.zeros(2)})
        assert counters == {"dcn_fwd": 3 * step, "dcn_bwd": 2 * step}
    assert graphs.calls == {"eager": 1, "captures": 1, "replays": 4}


def test_invalidate_drops_every_graph():
    graphs = StepGraphs("cpu", StandInGraph, counters={})
    for _ in range(2):
        graphs("a", lambda i: i["x"] + 1, {"x": torch.zeros(1)})
        graphs("b", lambda i: i["x"] + 2, {"x": torch.zeros(1)})
    assert len(graphs) == 2
    graphs.invalidate()
    assert len(graphs) == 0 and graphs.generation == 1
    graphs("a", lambda i: i["x"] + 1, {"x": torch.zeros(1)})
    assert graphs.calls["eager"] == 3 and len(graphs) == 0


# ---------------------------------------------------------------------------
# the trainer


def small_trainer(*extra, graphs=True):
    trainer = build_trainer(compose(sl.OVERRIDES + sl.PORT_ONLY + list(extra)),
                            device="cpu", graphs=graphs)
    trainer.init_done()
    return trainer


def test_the_cpu_runs_eagerly_unless_given_a_graph_factory():
    assert small_trainer().step_graphs is None
    assert small_trainer(graphs=False).step_graphs is None


def test_trainer_steps_go_through_the_graphs():
    trainer = small_trainer()
    graphs = stand_in_graphs(trainer)
    data = sl.make_batch(0)
    held = [trainer.step(data)["stats"] for _ in range(3)]
    assert graphs.calls == {"eager": 1, "captures": 1, "replays": 2}
    assert trainer.global_step == 3
    # each step's stats are its own, unchanged by the next step
    losses = [float(s["total_loss"]) for s in held]
    assert len(set(losses)) == 3
    for _ in range(2):
        out = trainer.step(sl.make_batch(7), is_training=False)
        dets = trainer.get_detections(out, sl.make_batch(7))
    assert graphs.calls["captures"] == 3  # eval and decode
    assert dets["pred_scores"].shape == (sl.BATCH, sl.MAX_DET)
    assert [float(s["total_loss"]) for s in held] == losses


@pytest.mark.parametrize("event", ["degrade", "learning_rate", "resume"])
def test_events_that_drop_the_graphs(event, tmp_path):
    # dcn_impl auto: the CPU runs the exact op, but the layers are not yet
    # switched to it, so the degrade has something to switch
    trainer = small_trainer("dcn_impl=auto")
    graphs = stand_in_graphs(trainer)
    data = sl.make_batch(0)
    for _ in range(2):
        trainer.step(data)
    assert len(graphs) == 1
    if event == "degrade":
        assert not trainer.maybe_degrade_dcn(PALLAS_MAX_SHIFT - 1.0)
        assert len(graphs) == 1
        assert trainer.maybe_degrade_dcn(PALLAS_MAX_SHIFT)
    elif event == "learning_rate":
        # MultiStepLR [30, 60]: no change at epoch 1 keeps the graphs
        trainer.epoch_end()
        assert len(graphs) == 1
        trainer.epoch = 29
        trainer.epoch_end()
        assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)
    else:
        trainer.save_model(tmp_path / "m.ckpt", 3, with_optimizer=True)
        assert trainer.load_model(tmp_path / "m.ckpt", resume=True) == 4
    assert len(graphs) == 0 and graphs.generation == 1
    trainer.step(data)
    trainer.step(data)
    assert graphs.calls["captures"] == 2


# ---------------------------------------------------------------------------
# trajectories against the eager port and the JAX package


def jax_baseline(ovr):
    """The JAX package's baseline trainer on ``tests/test_torch_slice.py``'s
    narrow DLA, initialised."""
    from centernet_uda_tpu import config as jax_config
    from centernet_uda_tpu.losses.centernet import DetectionLoss as JaxLoss
    from centernet_uda_tpu.models import common as jax_common
    from centernet_uda_tpu.models.dla import DLASeg as JaxDLASeg
    from centernet_uda_tpu.uda.base import Model as JaxModel
    from centernet_uda_tpu.utils import optim as jax_optim

    jcfg = jax_config.compose(ovr)
    heads = jax_common.make_heads_dict(sl.NUM_CLASSES, 0, False)
    jm = JaxModel()
    jm.cfg = jcfg
    jm.backend = jax_common.Backend(
        module=JaxDLASeg(heads=heads, head_conv=sl.HEAD_CONV,
                         levels=sl.LEVELS, channels=sl.CHANNELS),
        down_ratio=4, rotated_boxes=False, num_classes=sl.NUM_CLASSES,
        num_keypoints=0, heads=heads, name="dla34")
    jm.centernet_loss = JaxLoss(**jcfg.model.backend.loss.params.to_dict())
    jm.optimizer_cfg = jcfg.optimizer.to_dict()
    sched = jcfg.optimizer.scheduler
    jm.scheduler = jax_optim.make_scheduler(sched.name, sched.params)
    jm.init_done()
    return jm


def three_steps(make_batch, to_jax, jm, eager, graphed):
    """[(graphed, eager, JAX)] stats of 3 train steps on distinct batches,
    and the two ports' parameters after them."""
    steps = []
    for seed in range(3):
        data = make_batch(seed)
        want = {k: float(v) for k, v in
                jm.step(to_jax(data), is_training=True)["stats"].items()}
        e = {k: v.item() for k, v in eager.step(data)["stats"].items()}
        g = {k: v.item() for k, v in graphed.step(data)["stats"].items()}
        steps.append((g, e, want))
    assert graphed.step_graphs.calls == {"eager": 1, "captures": 1,
                                         "replays": 2}
    return steps, (state_of(graphed), state_of(eager))


@pytest.fixture(scope="module")
def baseline_runs():
    with tw.Twins():
        jm = jax_baseline(sl.OVERRIDES)
        eager, graphed = (tw.port_trainer(sl.OVERRIDES, jm) for _ in range(2))
        stand_in_graphs(graphed)
        return three_steps(sl.make_batch, sl.to_jax, jm, eager, graphed)


@pytest.fixture(scope="module")
def advent_runs():
    ovr = tw.overrides("adversarial_entropy_minimization", 128,
                       "model.uda.AdversarialEntropyMinimization."
                       "adversarial_weight=1.0")
    with tw.Twins():
        jm = tw.jax_trainer(ovr)
        eager, graphed = (tw.port_trainer(ovr, jm) for _ in range(2))
        stand_in_graphs(graphed)
        return three_steps(lambda s: tw.make_batch(s, 128), tw.to_jax, jm,
                           eager, graphed)


@pytest.mark.parametrize("trainer", ["baseline", "advent"])
def test_graphed_trajectory_is_the_eager_one_bit_for_bit(
        trainer, baseline_runs, advent_runs):
    steps, (got, want) = {"baseline": baseline_runs,
                          "advent": advent_runs}[trainer]
    for g, e, _ in steps:
        assert g == e
    assert len(got) == len(want) > 10
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("step", [0, 1, 2])
@pytest.mark.parametrize("trainer", ["baseline", "advent"])
def test_graphed_trajectory_matches_jax(trainer, step, baseline_runs,
                                        advent_runs):
    steps, _ = {"baseline": baseline_runs, "advent": advent_runs}[trainer]
    got, _, want = steps[step]
    assert set(got) == set(want)
    if trainer == "advent":
        assert {"dis_source", "dis_target", "dis_fool"} <= set(got)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-3), k
    if step:
        assert got["total_loss"] != steps[step - 1][0]["total_loss"]


def test_advent_discriminator_schedule_drops_the_graphs():
    ovr = tw.overrides(
        "adversarial_entropy_minimization", 128,
        "model.uda.AdversarialEntropyMinimization.optimizer.scheduler="
        "{name: MultiStepLR, params: {milestones: [1], gamma: 0.1}}")
    trainer = build_trainer(compose(ovr + tw.PORT_ONLY), device="cpu")
    trainer.init_done()
    graphs = stand_in_graphs(trainer)
    data = tw.make_batch(0, 128)
    trainer.step(data)
    trainer.step(data)
    assert len(graphs) == 1
    # the model's own schedule (MultiStepLR [30, 60]) does not move at
    # epoch 1; the discriminator's does
    trainer.epoch_end()
    assert trainer.disc_optimizer.param_groups[0]["lr"] == pytest.approx(
        1e-4)
    assert len(graphs) == 0
    moved = np.isfinite([float(v) for v in
                         trainer.step(data)["stats"].values()]).all()
    assert moved
