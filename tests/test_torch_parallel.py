"""The port's data parallelism (``centernet_uda_torch/parallel/ddp.py``) and
``bn_sync`` on the CPU.

- Grouped BatchNorm: the port's ``BatchNorm2d`` with ``bn_sync`` 2 and 4
  against the JAX package's ``GroupedBatchNorm`` (outputs and running
  statistics within 1e-5 of their scale: f32 moments in another order),
  its gradients against the port's own float64 run (within 1e-5 of their
  scale: the JAX module's one-pass variance puts f32 noise into its
  gradients, ``tests/test_torch_resnet.py``), and a group count that does
  not divide the batch as one group.
- Two ranks: two gloo processes (``tests/torch_ddp_worker.py``, each with a
  join timeout, killed on expiry) take 2 train steps of a narrow DLA on
  their halves of the same global batches as one process on the whole
  batch: ``bn_sync: global`` (against ``global``), ``replica`` (against
  ``bn_sync: 2`` on one process) and ADVENT's two optimizers. Every stat
  of every step within 1e-5 relative, every parameter and BatchNorm
  statistic within 1e-5 of its tensor's scale (1e-6 at least: a conv bias
  before a BatchNorm has no gradient but noise). Both sides run the
  backend in float64 (the losses in float32) with the exact DCN op: in
  float32 the ranks' other summation order, through BatchNorm's backward
  on the 2 x 2 maps, moved the first layer's update by 1e-4 of itself
  (measured), and the kernel path's bf16 rounding of its samples turned
  such differences into 5e-4 of the loss at the first step; in float64
  the largest difference is 2e-6 of an update. The optimizers are SGD with
  momentum: Adam's first steps are about lr * sign(g), so a reordering
  that flips the sign of a gradient near zero moves a parameter by 2 lr.
- Compiled steps under two ranks: the same runs through ``StepGraphs``
  with the CPU stand-in of a CUDA graph (``tests/torch_graph_stand_in.py``;
  its capture runs the step's collectives, which the ranks all do at the
  same call), for ``bn_sync: global`` (the cross-rank all-gather) and
  ADVENT (both optimizers' gradients in one all-reduce): over 8 steps that
  meet the three events that drop the graphs (``torch_ddp_worker.EVENTS``:
  a degrade forced through rank 0's ``dcn_max_abs_dy``, a MultiStepLR
  milestone, a ``load_model``), bit for bit the eager ranks' trajectory
  through the same events, with both ranks at the same graph generation
  and calls; over 3 steps (eager, capture and replay, replay) within the
  bound above of one process. Longer runs part from one process by more
  than that bound whatever runs the steps (the eager ranks do too, by the
  eighth step, in both cases), so the 8-step runs are held to the eager
  ranks alone.
- ``main()`` under two ranks (as ``torchrun`` starts them) on a tiny COCO
  set: rank 0 alone writes ``config.yaml``, logs and the checkpoints (the
  module's own names), its evaluator takes both ranks' detections, and the
  mAP and losses equal the single process's on every rank; ``mesh: {data:
  1}`` runs one gloo rank inside ``main()`` with the single process's
  results.
"""

import json
import logging
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from centernet_uda_tpu.models.common import GroupedBatchNorm
from centernet_uda_torch import train
from centernet_uda_torch.config import compose
from centernet_uda_torch.models.common import BatchNorm2d
from centernet_uda_torch.ops.gaussian import encode_targets
from centernet_uda_torch.parallel import ddp
from tests import torch_ddp_worker
from tests.util_fixtures import make_tiny_coco

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
TOL = 1e-5
NARROW = ["model.backend.params.levels=[1,1,1,1,1,1]",
          "model.backend.params.channels=[4,8,8,16,16,32]",
          "model.backend.params.head_conv=8",
          "model.backend.params.num_classes=2", "max_detections=10",
          "dcn_impl=xla"]
SGD = ["optimizer.name=SGD", "optimizer.params.lr=0.01",
       "optimizer.params.momentum=0.9", "optimizer.params.weight_decay=0.0001"]


def run_procs(cmds, timeout_s=TIMEOUT_S):
    """Run ``[(argv, cwd, env), ...]`` together; kill them all when one
    outlives ``timeout_s``. Returns their (returncode, stdout, stderr)."""
    procs = [subprocess.Popen(argv, cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv, cwd, env in cmds]
    deadline = time.monotonic() + timeout_s
    results = []
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(deadline - time.monotonic(), 1))
            results.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank outlived {timeout_s} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def env(**extra):
    return {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
            **{k: str(v) for k, v in extra.items()}}


# --------------------------------------------------------------------------
# grouped BatchNorm
# --------------------------------------------------------------------------


def bn_inputs(seed, batch=8, channels=5):
    rng = np.random.RandomState(seed)
    # a mean far from zero and groups of different scales: the moments'
    # f32 cancellation is exercised
    x = (rng.randn(batch, channels, 6, 7) * 2.0 + 3.0).astype(np.float32)
    x *= np.repeat(rng.rand(4) + 0.5, batch // 4)[:, None, None, None]
    scale = (rng.rand(channels) + 0.5).astype(np.float32)
    bias = rng.randn(channels).astype(np.float32)
    return x, scale, bias


def port_bn(groups, scale, bias, dtype=torch.float32):
    bn = BatchNorm2d(len(scale))
    bn.groups = groups
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(scale))
        bn.bias.copy_(torch.tensor(bias))
        bn.running_var.fill_(1.5)
    return bn.to(dtype).train()


def scaled_close(got, want, name, tol=TOL, floor=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: {err:.3g} of scale {scale:.3g}"


@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_batchnorm_matches_jax(groups):
    x, scale, bias = bn_inputs(0)
    module = GroupedBatchNorm(groups=groups, use_running_average=False)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": np.zeros(5, np.float32),
                                 "var": np.full(5, 1.5, np.float32)}}
    want, state = module.apply(variables, x.transpose(0, 2, 3, 1),
                               mutable=["batch_stats"])
    bn = port_bn(groups, scale, bias)
    got = bn(torch.tensor(x))
    scaled_close(got.detach().numpy().transpose(0, 2, 3, 1), want, "out")
    scaled_close(bn.running_mean.numpy(), state["batch_stats"]["mean"],
                 "running mean")
    scaled_close(bn.running_var.numpy(), state["batch_stats"]["var"],
                 "running var")
    assert int(bn.num_batches_tracked) == 1
    # eval mode normalises with the running statistics, as flax's does
    want_eval = module.clone(use_running_average=True).apply(
        {"params": variables["params"], "batch_stats": state["batch_stats"]},
        x.transpose(0, 2, 3, 1))
    with torch.no_grad():
        got_eval = bn.eval()(torch.tensor(x))
    scaled_close(got_eval.numpy().transpose(0, 2, 3, 1), want_eval, "eval")


@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_batchnorm_gradients_match_float64(groups):
    x, scale, bias = bn_inputs(1)
    coef = np.random.RandomState(2).randn(*x.shape)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        bn = port_bn(groups, scale, bias, dtype)
        xt = torch.tensor(x, dtype=dtype, requires_grad=True)
        (bn(xt) * torch.tensor(coef, dtype=dtype)).sum().backward()
        grads[dtype] = {"x": xt.grad, "weight": bn.weight.grad,
                        "bias": bn.bias.grad}
    for k, g in grads[torch.float32].items():
        scaled_close(g.numpy(), grads[torch.float64][k].numpy(), f"d{k}")

    # groups normalise apart: with the first group's outputs out of the
    # loss, its rows get no gradient and the others do
    rows = len(x) // groups
    coef[:rows] = 0.0
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    bn = port_bn(groups, scale, bias, torch.float64)
    (bn(xt) * torch.tensor(coef)).sum().backward()
    assert float(xt.grad[:rows].abs().max()) == 0.0
    assert float(xt.grad[rows:].abs().min()) > 0.0


def test_group_count_that_does_not_divide_is_one_group():
    x, scale, bias = bn_inputs(3, batch=8)
    with torch.no_grad():
        got = port_bn(3, scale, bias)(torch.tensor(x))
        want = port_bn(1, scale, bias)(torch.tensor(x))
    scaled_close(got.numpy(), want.numpy(), "out")


def test_plan_ranks_follows_the_jax_package():
    cpu = torch.device("cpu")
    assert ddp.plan_ranks(compose(["experiment=baseline"]), cpu) == (0, None)
    assert ddp.plan_ranks(compose(["mesh={data: 1}", "batch_size=3"]),
                          cpu) == (1, None)
    n, why = ddp.plan_ranks(compose(
        ["experiment=adversarial_entropy_minimization_dla"]), cpu)
    assert n == 0 and why == ("requested 2-way data parallelism but only 1 "
                              "device(s) available; running single-device")
    n, why = ddp.plan_ranks(compose(["mesh={data: 1}", "gpu=[0,1,2]"]), cpu)
    assert n == 1 and why is None  # mesh.data wins over a gpu list
    if not torch.cuda.is_available():
        assert ddp.plan_ranks(compose(["gpu=[0]"]),
                              torch.device("cuda"))[0] == 0


@pytest.mark.parametrize("count", [2, 4])
def test_plan_ranks_takes_every_visible_card_when_nothing_asks(
        count, monkeypatch):
    """The JAX package's auto mesh (``_should_auto_mesh``): with ``count``
    cards visible (patched) and nothing asking, a batch that divides over
    them takes one rank per card, one that does not stays on one device,
    and so does the CPU; an asked-for degree wins, and one that the cards
    cannot take warns and then follows the auto rule, as there, and the
    warning names where the run goes."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert ddp.plan_ranks(compose(["batch_size=16"]), cuda) == (count, None)
    assert ddp.plan_ranks(compose([f"batch_size={4 * count + 1}"]),
                          cuda) == (0, None)
    assert ddp.plan_ranks(compose(["batch_size=16"]), cpu) == (0, None)
    assert ddp.plan_ranks(compose(["mesh={data: 1}", "batch_size=16"]),
                          cuda) == (1, None)
    n, why = ddp.plan_ranks(compose(["mesh={data: 8}", "batch_size=16"]),
                            cuda)
    assert n == count and why == (
        f"requested 8-way data parallelism but only {count} device(s) "
        f"available; running on the {count} visible devices")
    n, why = ddp.plan_ranks(compose(
        ["mesh={data: 8}", f"batch_size={4 * count + 1}"]), cuda)
    assert n == 0 and why == (
        f"requested 8-way data parallelism but only {count} device(s) "
        "available; running single-device")


def test_one_process_collectives_are_identities():
    t = torch.arange(4.0)
    assert ddp.global_sum(t) is t and ddp.gather_rows(t) is t
    assert ddp.rank_share(t) is t and ddp.reduce_stats({"a": t}) == {"a": t}
    assert ddp.gather_to_main(3) == [3] and ddp.broadcast_from_main(5) == 5


# --------------------------------------------------------------------------
# two ranks against one process
# --------------------------------------------------------------------------


def global_batches(tmp_path, size, steps=2, batch=4, target=False):
    rng = np.random.RandomState(7)
    out = size // 4
    arrays = {}
    for s in range(steps):
        ts = []
        for _ in range(batch):
            n = rng.randint(1, 4)
            xy = rng.rand(n, 2) * out * 0.6
            boxes = np.concatenate([xy, xy + rng.rand(n, 2) * out * 0.3 + 2],
                                   1)
            ts.append(encode_targets(boxes, rng.randint(0, 2, n), out, out,
                                     2, 10))
        data = {k: np.stack([t[k] for t in ts]) for k in ts[0]}
        data["input"] = rng.randn(batch, 3, size, size).astype(np.float32)
        if target:
            data["target_domain_input"] = (
                rng.randn(batch, 3, size, size) * 0.5 + 0.3).astype(
                    np.float32)
        arrays.update({f"{s}/{k}": v for k, v in data.items()})
    path = tmp_path / "batches.npz"
    np.savez(path, **arrays)
    return path


def two_ranks(tmp_path, overrides, batches, name="ranks", **options):
    """Rank 0's results of two gloo ranks (``options``: the worker's spec
    keys ``graphs`` and ``events``; with ``events`` rank 1's too, as
    ``[rank 0's, rank 1's]``)."""
    spec = {"overrides": overrides, "batches": str(batches),
            "out": str(tmp_path / f"{name}.pt"), **options}
    (tmp_path / f"{name}.json").write_text(json.dumps(spec))
    port = ddp.free_port()
    results = run_procs([([sys.executable, "tests/torch_ddp_worker.py",
                           str(r), "2", str(port),
                           str(tmp_path / f"{name}.json")], ROOT, env())
                         for r in range(2)])
    for rc, _, err in results:
        assert rc == 0, err[-3000:]
    if options.get("events"):
        return [torch.load(path, weights_only=True)
                for path in (spec["out"], spec["out"] + ".1")]
    return torch.load(spec["out"], weights_only=True)


def one_process(tmp_path, overrides, batches, **options):
    spec = {"overrides": overrides, "batches": str(batches),
            "out": str(tmp_path / "single.pt"), **options}
    torch_ddp_worker.run(0, 0, 0, spec)
    return torch.load(spec["out"], weights_only=True)


# the fool loss at full weight, and the discriminator's own optimizer SGD
# too (its default is Adam)
ADVENT = ["model.uda.AdversarialEntropyMinimization.adversarial_weight=1.0",
          "model.uda.AdversarialEntropyMinimization.optimizer={name: SGD, "
          "params: {lr: 0.01, momentum: 0.9}}"]

RANK_CASES = {
    # (overrides of the ranks, of the single process, input size)
    "global": (["experiment=baseline", "bn_sync=global"],
               ["experiment=baseline", "bn_sync=global"], 64),
    "replica": (["experiment=baseline", "bn_sync=replica"],
                ["experiment=baseline", "bn_sync=2"], 64),
    "advent": (["experiment=adversarial_entropy_minimization"] + ADVENT,
               ["experiment=adversarial_entropy_minimization"] + ADVENT, 128),
}


def ranks_match_one_process(got, want, steps):
    """Every stat of every step within TOL relative, every parameter and
    BatchNorm statistic within TOL of its tensor's scale."""
    assert len(got["stats"]) == len(want["stats"]) == steps
    for step, (g, w) in enumerate(zip(got["stats"], want["stats"])):
        assert set(g) == set(w), step
        for k in w:
            assert math.isclose(g[k], w[k], rel_tol=TOL, abs_tol=1e-9), (
                step, k, g[k], w[k])
    assert set(got["params"]) == set(want["params"])
    moved = 0
    for k, w in want["params"].items():
        if not w.is_floating_point():  # num_batches_tracked
            assert torch.equal(got["params"][k], w), k
            continue
        scaled_close(got["params"][k].numpy(), w.numpy(), k, floor=1e-6)
        moved += not torch.equal(w, want["initial"][k])
    # the steps moved nearly every tensor (two idle runs would agree too)
    assert moved >= 0.9 * len(want["params"]) - 20, moved


@pytest.mark.parametrize("case", sorted(RANK_CASES))
def test_two_ranks_match_one_process(tmp_path, case):
    ranks_cfg, single_cfg, size = RANK_CASES[case]
    batches = global_batches(tmp_path, size, target=case == "advent")
    got = two_ranks(tmp_path, ranks_cfg + NARROW + SGD, batches)
    want = one_process(tmp_path, single_cfg + NARROW + SGD, batches)
    if case == "advent":
        assert any(k.startswith("disc.") for k in want["params"])
    ranks_match_one_process(got, want, 2)


GRAPHED_CASES = ("global", "advent")
# the events' run: 8 steps (EVENTS after steps 1, 3 and 5), and a DCN route
# that the degrade can switch (on the CPU "auto" runs the exact op)
EVENT_STEPS = 8
EVENTS_CFG = ["dcn_impl=auto"]


@pytest.fixture(scope="module")
def graphed_rank_runs(tmp_path_factory):
    """Per case of GRAPHED_CASES: through the events, the graphed ranks'
    results and the eager ranks' (both ranks' each); without them, 3 steps
    of the graphed ranks (rank 0's) and of one process."""
    cache = {}

    def get(case):
        if case not in cache:
            tmp = tmp_path_factory.mktemp(f"graphed_{case}")
            ranks_cfg, single_cfg, size = RANK_CASES[case]
            batches = global_batches(tmp, size, steps=EVENT_STEPS,
                                     target=case == "advent")
            extra = NARROW + SGD + EVENTS_CFG
            short = global_batches(tmp_path_factory.mktemp(f"short_{case}"),
                                   size, steps=3, target=case == "advent")
            cache[case] = {
                "graphed": two_ranks(tmp, ranks_cfg + extra, batches,
                                     "graphed", graphs=True, events=True),
                "eager": two_ranks(tmp, ranks_cfg + extra, batches,
                                   "eager", events=True),
                "graphed_short": two_ranks(tmp, ranks_cfg + NARROW + SGD,
                                           short, "short", graphs=True),
                "single_short": one_process(tmp, single_cfg + NARROW + SGD,
                                            short)}
        return cache[case]

    return get


@pytest.mark.parametrize("case", GRAPHED_CASES)
def test_graphed_ranks_are_the_eager_ranks_bit_for_bit(case,
                                                       graphed_rank_runs):
    runs = graphed_rank_runs(case)
    for graphed, eager in zip(runs["graphed"], runs["eager"]):
        assert graphed["stats"] == eager["stats"]
        assert set(graphed["params"]) == set(eager["params"])
        for k, v in eager["params"].items():
            assert torch.equal(graphed["params"][k], v), k
        assert eager["graphs"] is None


@pytest.mark.parametrize("case", GRAPHED_CASES)
def test_graphed_ranks_match_one_process(case, graphed_rank_runs):
    runs = graphed_rank_runs(case)
    assert runs["graphed_short"]["graphs"] == {
        "generation": 0, "calls": {"eager": 1, "captures": 1, "replays": 2}}
    ranks_match_one_process(runs["graphed_short"], runs["single_short"], 3)


@pytest.mark.parametrize("case", GRAPHED_CASES)
def test_graphed_ranks_drop_their_graphs_in_step(case, graphed_rank_runs):
    """Each event dropped every rank's graphs at the same call: per
    generation one eager call, one capture and one replay."""
    runs = graphed_rank_runs(case)["graphed"]
    rank0, rank1 = (r["graphs"] for r in runs)
    assert rank0 == rank1 == {
        "generation": 3, "calls": {"eager": 4, "captures": 4, "replays": 4}}
    # the degrade forced on rank 0 reached rank 1 through the maximum
    dys = [[s["dcn_max_abs_dy"] for s in r["stats"]] for r in runs]
    assert dys[0] == dys[1] and dys[1][1] == max(dys[1]) > 0


# --------------------------------------------------------------------------
# main() under two ranks
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_coco(tmp_path_factory.mktemp("coco"), num_images=8,
                          size=(64, 64), num_classes=3, seed=3)


def cli_overrides(tiny, *extra):
    img_dir, anno = tiny
    out = ["experiment=baseline", "dcn_impl=xla", "epochs=1", "batch_size=4",
           "num_workers=0", "max_detections=10",
           "model.backend.params.num_classes=3",
           "model.backend.params.levels=[1,1,1,1,1,1]",
           "model.backend.params.channels=[4,8,8,16,16,32]",
           "model.backend.params.head_conv=8",
           "datasets.training.params.augmentation=null"]
    for phase in ("training", "validation"):
        out += [f"datasets.{phase}.params.image_folder={img_dir}",
                f"datasets.{phase}.params.annotation_file={anno}",
                f"datasets.{phase}.params.input_size=[64,64]"]
    return out + list(extra)


MAIN = ("import json, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from centernet_uda_torch import train\n"
        "scalars = train.main(sys.argv[2:], device='cpu')\n"
        "json.dump({k: float(v) for k, v in scalars.items()},"
        " open(sys.argv[1], 'w'))\n")


def scalars_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("images_per_sec"):
            continue
        # the evaluator reports nan for an area no box of the set has
        assert (math.isnan(got[k]) and math.isnan(w)) or math.isclose(
            got[k], w, rel_tol=1e-4, abs_tol=1e-6), (k, got[k], w)


def test_main_under_two_ranks_matches_one_process(tiny, tmp_path,
                                                  monkeypatch):
    """Two ranks of batch 2 against one process of batch 4 (all three
    processes on one thread), in float32 and with SGD: scalars within 1e-4
    relative, the checkpoint's weights within 1e-3 of the weights' norm
    (measured: 1.3e-4). Tensor by tensor they part further, from float32
    summation order alone: one process on one thread and on two parts from
    itself by 2.3e-3 of the first conv's scale after these 2 steps
    (measured; BatchNorm's backward on the 2 x 2 maps amplifies it). The
    float64 comparison above holds the ranks' step itself at 1e-5."""
    overrides = cli_overrides(tiny, *SGD)
    port = ddp.free_port()
    dirs = [tmp_path / name for name in ("rank0", "rank1", "single")]
    cmds = []
    for r, d in enumerate(dirs):
        d.mkdir()
        ranks = dict(RANK=r, WORLD_SIZE=2, LOCAL_RANK=r, LOCAL_WORLD_SIZE=2,
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        cmds.append(([sys.executable, "-c", MAIN, str(d / "scalars.json"),
                      "--device", "cpu", *overrides], d,
                     env(**ranks) if r < 2 else env()))
    results = run_procs(cmds)
    for rc, _, err in results:
        assert rc == 0, err[-3000:]
    got = [json.loads((d / "scalars.json").read_text()) for d in dirs[:2]]
    want = json.loads((dirs[2] / "scalars.json").read_text())
    assert "MSCOCO_Precision/mAP" in want
    scalars_close(got[0], want)
    scalars_close(got[1], want)  # every rank takes rank 0's results
    run0, run1, single = (d / "outputs" / "baseline" for d in dirs)
    assert {"config.yaml", "model_best.ckpt", "model_last.ckpt"} <= {
        p.name for p in run0.iterdir()}
    assert list(run1.iterdir()) == []  # rank 1 writes nothing, logs neither
    assert "rank 0 of 2: batch 2 of the host's 4" in results[0][2]
    # the checkpoint keeps the module's own names, and the single
    # process's weights
    saved = torch.load(run0 / "model_last.ckpt", weights_only=True)
    ref = torch.load(single / "model_last.ckpt", weights_only=True)
    assert set(saved["state_dict"]) == set(ref["state_dict"])
    assert not any(k.startswith("module.") for k in saved["state_dict"])
    floats = [k for k, w in ref["state_dict"].items() if w.is_floating_point()]
    diff = sum(float((saved["state_dict"][k].double() - ref["state_dict"][
        k].double()).square().sum()) for k in floats)
    norm = sum(float(ref["state_dict"][k].double().square().sum())
               for k in floats)
    assert math.sqrt(diff / norm) <= 1e-3


def test_main_runs_one_rank_in_process(tiny, tmp_path, monkeypatch, caplog):
    """``mesh: {data: 1}``: ``main()`` joins a one-rank gloo group itself
    (nothing to start) and leaves no group behind."""
    monkeypatch.chdir(tmp_path)
    want = train.main(cli_overrides(tiny), device="cpu")
    with caplog.at_level(logging.INFO, logger="uda"):
        got = train.main(cli_overrides(tiny, "mesh={data: 1}"),
                         device="cpu")
    assert "rank 0 of 1: batch 4 of the host's 4" in caplog.text
    assert not ddp.is_distributed()
    scalars_close(got, want)


def test_distributed_true_needs_a_launcher(tiny, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        train.main(cli_overrides(tiny, "distributed=true"), device="cpu")
