"""The compiled steps (``centernet_uda_torch/utils/graphs.py``) on the CPU.

A CUDA graph needs a card, so ``StepGraphs`` gets a stand-in for it here
(``tests/torch_graph_stand_in.py``). With it the helper's own logic runs
as on the card: the first call of a signature eager, the second capturing
and replaying once, later ones replaying; copies returned; invalidation;
launch accounting; the generators a step draws from handed to the graph;
a failed capture raised, never run eagerly instead. ``CudaGraph`` itself,
with torch's graph calls stood in: the collector runs before a capture and
not during it.

Trajectories: a narrow DLA-34 at 64 px (``tests/test_torch_slice.py``'s
config, Adam at lr 1e-3) and ADVENT at 128 px
(``tests/test_torch_uda_twins.py``'s), 3 train steps on distinct seeded
batches, through the stand-in: bit for bit the eager port's trajectory
(same ops on the same values in the same order), and within 1e-3 relative
of the JAX package's jitted steps, the bound of
``test_torch_slice.py::test_loss_trajectory_matches_jax``.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from centernet_uda_torch.config import compose
from centernet_uda_torch.ops.dcn import PALLAS_MAX_SHIFT
from centernet_uda_torch.train import build_trainer
from centernet_uda_torch.utils import graphs as graphs_lib
from centernet_uda_torch.utils.graphs import StepGraphs
from tests import test_torch_slice as sl
from tests import test_torch_uda_twins as tw
from tests.torch_graph_stand_in import (StandInGraph, stand_in_graphs,
                                        state_of)

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the helper


def test_first_call_eager_then_capture_then_replay_and_new_shapes():
    state = torch.zeros(())
    calls = []

    def fn(inputs):
        calls.append(tuple(inputs["x"].shape))
        state.add_(1)
        return {"y": inputs["x"] * 2 + state}

    graphs = StepGraphs("cpu", lambda gens: StandInGraph(gens,
                                                         lambda: [state]),
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

    graphs = StepGraphs("cpu", lambda gens: StandInGraph(
        gens, counters=counters), counters=counters)
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


def test_the_generators_reach_the_graph_and_each_replay_redraws():
    """A step that draws from a generator of its own names it; the graph
    gets it, and a replay after ``manual_seed`` draws what an eager call
    after the same seed draws (a registered CUDA generator's replay reads
    its host seed and offset)."""
    gen = torch.Generator()
    made = []

    def factory(generators):
        made.append(generators)
        return StandInGraph(generators)

    def fn(inputs):
        return {"y": inputs["x"] + torch.rand(5, generator=gen),
                "z": torch.rand(2, 3, generator=gen)}

    graphs = StepGraphs("cpu", factory, counters={})
    for step in range(4):
        gen.manual_seed(100 + step)
        got = graphs("step", fn, {"x": torch.zeros(5)}, (gen,))
        gen.manual_seed(100 + step)
        want = fn({"x": torch.zeros(5)})
        assert torch.equal(got["y"], want["y"]), step
        assert torch.equal(got["z"], want["z"]), step
    assert made == [(gen,)]
    assert graphs.calls == {"eager": 1, "captures": 1, "replays": 3}


class FailingGraph(StandInGraph):
    """A capture that fails, as one that calls ``.item()`` does on the
    card."""

    def capture(self, fn):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")


def test_a_failed_capture_raises_and_does_not_fall_back():
    runs = []

    def fn(inputs):
        runs.append(1)
        return {"y": inputs["x"] + 1}

    graphs = StepGraphs("cpu", FailingGraph, counters={})
    graphs("step", fn, {"x": torch.zeros(2)})
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing"):
            graphs("step", fn, {"x": torch.zeros(2)})
    # the eager call ran the step; the failed captures ran nothing instead
    assert len(runs) == 1 and len(graphs) == 0
    assert graphs.calls == {"eager": 1, "captures": 0, "replays": 0}


class _Node:
    """A weakly referable object for a reference cycle."""


@pytest.mark.parametrize("fails", [False, True])
@pytest.mark.parametrize("collector_on", [True, False])
def test_a_cuda_capture_collects_first_and_not_during_it(monkeypatch, fails,
                                                         collector_on):
    """``CudaGraph.capture`` (torch's graph and capture context stood in):
    garbage in a reference cycle, as a dropped trainer's graphs are, is
    collected before the captured function runs; the collector is off while
    it runs (a graph it frees there would break the capture) and after the
    capture, failed or not, on or off as it was before."""
    seen = []

    class Graph:
        def register_generator_state(self, gen):
            seen.append(("generator", gen))

    class Capture:
        def __init__(self, graph, pool=None, capture_error_mode=None):
            seen.append(("mode", capture_error_mode))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    gen = torch.Generator()

    def fn():
        seen.append(("dead", ref() is None))
        seen.append(("collector on", gc.isenabled()))
        if fails:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return "outputs"

    was = gc.isenabled()
    gc.disable()  # the cycle stays until something collects it
    try:
        node = _Node()
        node.self = node
        ref = weakref.ref(node)
        del node
        if collector_on:
            gc.enable()
        graph = graphs_lib.CudaGraph(None, (gen,))
        if fails:
            with pytest.raises(RuntimeError, match="capturing"):
                graph.capture(fn)
        else:
            assert graph.capture(fn) == "outputs"
        assert gc.isenabled() == collector_on
    finally:
        if was:
            gc.enable()
        else:
            gc.disable()
    assert seen == [("generator", gen), ("mode", "thread_local"),
                    ("dead", True), ("collector on", False)]


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


# ---------------------------------------------------------------------------
# EfficientNet: its stochastic-depth generator inside the graph


def drop_blocks(net):
    from centernet_uda_torch.models.efficientnet import MBConv

    return sum(1 for m in net.modules() if isinstance(m, MBConv)
               and m.use_res and m.drop_rate > 0)


@pytest.fixture(scope="module")
def effnet_runs():
    """EfficientNet-b0 (``experiment=keypoints`` on the baseline trainer)
    at 64 px, its stochastic depth on: 3 train steps of an eager and of a
    graphed trainer from one seed, with each step's masks (those of its
    last forward) and stats, and both trainers."""
    from centernet_uda_torch.models import efficientnet
    from tests import test_torch_efficientnet_trainer as ek

    drawn = []
    draw = efficientnet.drop_connect

    def recording(x, keep, mask):
        drawn.append(mask.clone())
        return draw(x, keep, mask)

    runs = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(efficientnet, "drop_connect", recording)
    try:
        for run in ("eager", "graphed"):
            trainer = build_trainer(compose(ek.OVERRIDES), device="cpu")
            trainer.init_done()
            if run == "graphed":
                stand_in_graphs(trainer)
            blocks = drop_blocks(trainer.backend.module)
            steps = []
            for seed in range(3):
                stats = trainer.step(ek.make_batch(seed, 64))["stats"]
                steps.append(({k: v.item() for k, v in stats.items()},
                              drawn[-blocks:]))
            runs[run] = (trainer, steps)
    finally:
        mp.undo()
    return runs


def test_efficientnet_graphed_trajectory_is_the_eager_one_bit_for_bit(
        effnet_runs):
    (eager, e_steps), (graphed, g_steps) = (effnet_runs["eager"],
                                            effnet_runs["graphed"])
    assert graphed.compiled("train") and graphed.drop_generator is not None
    assert graphed.step_graphs.calls == {"eager": 1, "captures": 1,
                                         "replays": 2}
    for (g, g_masks), (e, e_masks) in zip(g_steps, e_steps):
        assert g == e
        assert len(g_masks) == len(e_masks) > 5
        for a, b in zip(g_masks, e_masks):
            assert torch.equal(a, b)
    # the masks drop samples, and another step count draws other masks
    masks = [torch.cat([m.flatten() for m in ms]) for _, ms in e_steps]
    assert not all(bool(m.all()) for m in masks)
    assert not torch.equal(masks[0], masks[1])
    for a, b in zip(state_of(graphed), state_of(eager)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def effnet_jax_runs():
    """``tests/test_torch_efficientnet_trainer.py``'s three steps (128 px,
    Adam at lr 1e-4, stochastic depth off on both sides) with the port's
    trainer graphed."""
    from centernet_uda_tpu.models import common as jax_common
    from tests import test_torch_efficientnet_trainer as ek

    old = jax_common.get_bn_groups()
    jax_common.set_bn_groups(1)
    try:
        jm = ek.jax_trainer()
        port = ek.port_trainer(jm)
        stand_in_graphs(port)
        steps = []
        for seed in range(3):
            data = ek.make_batch(seed)
            want = jm.step(ek.to_jax(data), is_training=True)["stats"]
            got = port.step(data, is_training=True)["stats"]
            steps.append(({k: float(v) for k, v in got.items()},
                          {k: float(v) for k, v in want.items()}))
    finally:
        jax_common.set_bn_groups(old)
    assert port.step_graphs.calls == {"eager": 1, "captures": 1,
                                      "replays": 2}
    return steps


@pytest.mark.parametrize("step", [0, 1, 2])
def test_efficientnet_graphed_trajectory_matches_jax(step, effnet_jax_runs):
    got, want = effnet_jax_runs[step]
    assert set(got) == set(want)
    for k in ("hm_loss", "wh_loss", "off_loss", "kp_loss", "total_loss"):
        assert got[k] == pytest.approx(want[k], rel=1e-3), k
    if step:
        assert got["total_loss"] != effnet_jax_runs[step - 1][0][
            "total_loss"]
