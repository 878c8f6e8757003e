"""The system under test, driven as its users drive it: one function per
entry a mix names (``train``, ``eval``, ``serve``).

Each takes the run's ``Ctx`` and returns an ``Outcome``: the end-to-end
numbers it measured, the work attempted and failed in the window, the
device's memory peak, the program's answers for the check, and the host
spans of the benchmark's own wrappers. It frees the program's state before
it returns, so the reference runs on a card the program has left.

- ``train``: ``train.build_trainer`` (the CUDA-graph train step on the
  card), the benchmark's weights loaded by name, then the program's own
  phase loop ``train._run_phase(..., is_training=True)``: three set-up
  calls of one batch each (the eager call, the capture, the first replay),
  then the trainer's state put back to the seed's in place and the same
  three batches again, each call now a replay of the graph the window
  replays, whose losses, first gradient and change the check reads; then
  the window:
  the mix's cycle of pinned batches until ``--seconds`` have passed, and
  the loop's final flush, which waits for the last step.
- ``eval``: the same trainer and ``_run_phase(..., is_training=False)``
  with the port's COCO ``Evaluator`` (no TensorBoard logger): forward,
  loss, decode, ``get_detections`` and ``add_batch`` per batch.
- ``serve``: ``export.ServingModule`` with decode, exported by
  ``export.export_program``, written and loaded by ``export.load_artifact``
  under ``TMPDIR``; one client calls it in a closed loop on the device's
  seeded images, each call synchronised.
"""

from __future__ import annotations

import gc
import os
import random
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench import gen
from perfbench import weights as weights_lib
from perfbench.check import make_net


@dataclass
class Ctx:
    workload: str
    config: dict
    mix: dict
    seed: int
    seconds: float
    device: torch.device
    tracer: Optional[object] = None
    overrides: List[str] = field(default_factory=list)
    patch: Optional[Callable] = None  # tests: breaks the timed path

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclass
class Outcome:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    memory_peak: int
    answers: object
    items_traced: int = 0
    spans: Dict[str, List[float]] = field(default_factory=dict)
    notes: Dict[str, object] = field(default_factory=dict)


class Reservoir:
    """A uniform sample of ``size`` of a stream's items, drawn from the
    seed (reservoir sampling)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(int(seed) * 7919 + 17)
        self.items: Dict[int, dict] = {}
        self.seen = 0

    def slot(self) -> Optional[int]:
        """The slot the next item takes, or None where it is not kept."""
        i = self.seen
        self.seen += 1
        if i < self.size:
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.size else None


class Window:
    """The batches of the window: the cycle from ``start``, until
    ``seconds`` have passed since the first was asked for. Drives the
    tracer between batches."""

    def __init__(self, ctx: Ctx, cycle: List[dict], start: int, images: int):
        self.ctx, self.cycle, self.at = ctx, cycle, start
        self.images = images
        self.t0: Optional[float] = None
        self.index = -1
        self.stamps: List[float] = []  # when each batch was asked for

    def __iter__(self):
        return self

    def __next__(self):
        now = time.perf_counter()
        if self.t0 is None:
            self.t0 = now
        elapsed = now - self.t0
        tracer = self.ctx.tracer
        if elapsed >= self.ctx.seconds:
            if tracer is not None:
                tracer.stop(self.ctx.sync)
            raise StopIteration
        if tracer is not None:
            tracer.tick(elapsed, self.ctx.sync)
            tracer.count(self.images)
        self.index = self.at % len(self.cycle)
        self.at += 1
        self.stamps.append(time.perf_counter())
        return self.cycle[self.index]

    def quarter_rates(self, end: float) -> List[float]:
        """Images a second in each quarter of the window's batches (each
        batch from its ask to the next's, the last to ``end``): how far the
        rate moves within one run."""
        stamps = self.stamps + [end]
        n = len(self.stamps)
        out = []
        for q in range(4):
            a, b = q * n // 4, (q + 1) * n // 4
            if b > a:
                out.append(self.images * (b - a) / (stamps[b] - stamps[a]))
        return out


def _record(name: str):
    return torch.profiler.record_function(name)


def _compose(ctx: Ctx):
    from centernet_uda_torch import config as config_lib
    from centernet_uda_torch.train import CONFIG_DIR

    args = [f"experiment={ctx.config['experiment']}",
            *ctx.config.get("overrides", []), *ctx.overrides]
    return config_lib.compose(args, config_dir=str(CONFIG_DIR))


def _weights(ctx: Ctx, calibrate_size: Optional[int]):
    """The seed's weights; with ``calibrate_size``, BatchNorm's running
    statistics calibrated at that input size."""
    net = make_net(ctx.config["reference"])
    w = weights_lib.make(net.spec(), ctx.seed, ctx.device,
                         float(ctx.mix.get("offset_std", 0.5)))
    if calibrate_size:
        imgs = gen.images(ctx.seed, 3, 2, calibrate_size, ctx.device)
        weights_lib.calibrate(net, w, imgs)
    return w


def bn_stats(weights) -> Dict[str, torch.Tensor]:
    """The calibrated running statistics, kept for the check."""
    return {k: v.detach().cpu().clone() for k, v in weights.items()
            if k.endswith(("running_mean", "running_var"))}


def _trainer(ctx: Ctx, cfg, weights):
    from centernet_uda_torch.train import build_trainer

    trainer = build_trainer(cfg, device=ctx.device)
    trainer.backend.module.load_state_dict(weights)
    trainer.init_done()
    if ctx.patch is not None:
        ctx.patch(trainer)
    return trainer


def _free() -> None:
    """Return what the caller has let go of to the device."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _peak(ctx: Ctx) -> int:
    if ctx.device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(ctx.device))


def _meters(stats: dict) -> Dict[str, float]:
    return {k.split("/", 1)[1]: float(m.avg) for k, m in stats.items()
            if hasattr(m, "avg")}


def train(ctx: Ctx) -> Outcome:
    from centernet_uda_torch.train import _run_phase

    cfg = _compose(ctx)
    ref = ctx.config["reference"]
    w = _weights(ctx, None)
    trainer = _trainer(ctx, cfg, w)
    del w
    uda = bool(getattr(trainer, "requires_target_domain", False))
    b = gen.batch_size(ctx.mix, ref["batch_size"])
    cycle = gen.batches(ctx.mix, ctx.seed, ref["batch_size"],
                        ref["heads"]["hm"], ref["max_detections"], uda,
                        ctx.device)
    net = trainer.backend.module
    names = [n for n, _ in net.named_parameters()]
    params = [p for _, p in net.named_parameters()]
    p0 = [p.detach().clone() for p in params]
    b0 = {n: t.detach().clone() for n, t in net.named_buffers()}
    step0 = trainer.global_step

    def steps(first: int, last: int, keep=None):
        for i in range(first, last):
            stats = _run_phase(trainer, [cycle[i]], [], None, {}, 1,
                               "training", True, [])
            if keep is not None:
                keep(i, stats)

    # the eager call, the capture (and its replay) and a replay: what the
    # window replays exists from here on
    steps(0, 3)
    # back to the seed's state, in place (the graphs hold these tensors),
    # and the judged steps: the first three again, each a replay of the
    # graph the window replays
    _restore(trainer, params, p0, b0)
    trainer.global_step = step0
    losses, first = [], {}
    beta1 = trainer.optimizer.param_groups[0]["betas"][0]

    def keep(i, stats):
        losses.append(_meters(stats))
        if i > 0:
            return
        first["running"] = {n: t.detach().double().cpu().clone()
                            for n, t in net.named_buffers()
                            if n.endswith(("running_mean", "running_var"))}
        # a leaf no loss reaches (the outer project of a two-level DLA
        # tree) has no gradient and no Adam state
        state = trainer.optimizer.state
        first["grad_norms"] = {
            n: float(state[p]["exp_avg"].double().norm()) / (1 - beta1)
            if "exp_avg" in state[p] else 0.0
            for n, p in zip(names, params)}

    replays = _replays(trainer)
    steps(0, 3, keep)
    judged_replays = _replays(trainer) - replays
    change = {n: float((p.detach().double() - q.double()).norm())
              for n, p, q in zip(names, params, p0)}
    del p0, b0
    ctx.sync()
    _wrap_step(trainer)
    window = Window(ctx, cycle, 3, b)
    phases: List[dict] = []
    stats: dict = {}
    t0 = time.perf_counter()
    _run_phase(trainer, window, [], None, stats, 1, "training", True,
               phases)
    ctx.sync()
    t1 = time.perf_counter()
    images = int(phases[-1]["images"])
    steps = int(phases[-1]["steps"])
    meters = _meters(stats)
    finite = all(np.isfinite(v) for v in meters.values())
    out = Outcome(
        e2e={"train_images_per_s": images / (t1 - t0)},
        attempted=steps, failed=0 if finite else steps,
        memory_peak=_peak(ctx),
        answers={"losses": losses, "grad_norms": first["grad_norms"],
                 "change_norms": change, "running": first["running"],
                 "batches": cycle[:3], "judged_replays": judged_replays},
        items_traced=ctx.tracer.items if ctx.tracer is not None else 0,
        notes={"window_start": t0, "steps": steps,
               "dcn_max_abs_dy": meters.get("dcn_max_abs_dy"),
               "graph_calls": phases[-1].get("graph_calls"),
               "judged_replays": judged_replays,
               "quarter_rates": window.quarter_rates(t1)})
    del trainer, net, params, cycle
    _free()
    return out


@torch.no_grad()
def _restore(trainer, params, p0, b0) -> None:
    """The trainer's state back to the seed's, in place: parameters,
    buffers, and the optimizer's moments and step count zeroed (Adam's
    state before its first step)."""
    for p, q in zip(params, p0):
        p.copy_(q)
    for n, t in trainer.backend.module.named_buffers():
        t.copy_(b0[n])
    for state in trainer.optimizer.state.values():
        for v in state.values():
            if isinstance(v, torch.Tensor):
                v.zero_()


def _replays(trainer) -> int:
    graphs = trainer.step_graphs
    return 0 if graphs is None else int(graphs.calls["replays"])


def _wrap_step(trainer, keep: Optional[Callable] = None) -> None:
    """The benchmark's span around each call of ``trainer.step`` (and
    ``keep(outputs)`` on what it returns)."""
    inner = trainer.step

    def step(data, is_training=True):
        with _record("perfbench.step"):
            outputs = inner(data, is_training=is_training)
        if keep is not None:
            keep(outputs)
        return outputs

    trainer.step = step


class _Evaluator:
    """The port's evaluator behind the benchmark's span: each ``add_batch``
    timed on the host, and the detections of sampled calls kept."""

    def __init__(self, inner, spans: List[float], keep: Callable):
        self.inner, self.spans, self.keep = inner, spans, keep

    def add_batch(self, **detections):
        t = time.perf_counter()
        with _record("perfbench.evaluator.add_batch"):
            self.inner.add_batch(**detections)
        self.spans.append(time.perf_counter() - t)
        self.keep(detections)


def eval(ctx: Ctx) -> Outcome:  # noqa: A001 - the mix's entry name
    from centernet_uda_torch import evaluation
    from centernet_uda_torch.train import _run_phase

    cfg = _compose(ctx)
    ref = ctx.config["reference"]
    size = int(ctx.mix["input_size"])
    w = _weights(ctx, size)
    stats0 = bn_stats(w)
    trainer = _trainer(ctx, cfg, w)
    del w
    b = gen.batch_size(ctx.mix, ref["batch_size"])
    cycle = gen.batches(ctx.mix, ctx.seed, ref["batch_size"],
                        ref["heads"]["hm"], ref["max_detections"], False,
                        ctx.device)

    def evaluator():
        return evaluation.build("coco", per_class=True,
                                score_threshold=float(cfg.get(
                                    "score_threshold", 0.0)))

    # the eager call, the capture and a replay of the eval and decode steps
    _run_phase(trainer, cycle[:3], [evaluator()], None, {}, 1,
               "validation", False, [])
    ctx.sync()
    sample = Reservoir(int(ctx.mix.get("sample", 4)), ctx.seed)
    current = {"slot": None}
    window = Window(ctx, cycle, 3, b)

    def keep_step(outputs):
        slot = sample.slot()
        current["slot"] = slot
        if slot is not None:
            sample.items[slot] = {
                "batch": window.index, "stats": outputs["stats"],
                "heads": {k: outputs["source_domain"][k]
                          for k in ("hm", "wh", "reg")}}

    def keep_dets(d):
        slot = current["slot"]
        if slot is not None:
            sample.items[slot]["dets"] = {
                "boxes": d["pred_boxes"], "scores": d["pred_scores"],
                "classes": d["pred_classes"]}

    _wrap_step(trainer, keep_step)
    spans: List[float] = []
    phases: List[dict] = []
    stats: dict = {}
    t0 = time.perf_counter()
    _run_phase(trainer, window, [_Evaluator(evaluator(), spans, keep_dets)],
               None, stats, 1, "validation", False, phases)
    ctx.sync()
    t1 = time.perf_counter()
    images = int(phases[-1]["images"])
    steps = int(phases[-1]["steps"])
    answers = []
    for a in sample.items.values():
        a["stats"] = {k: float(v) for k, v in a["stats"].items()}
        answers.append(a)
    finite = all(np.isfinite(v) for v in _meters(stats).values())
    out = Outcome(
        e2e={"eval_images_per_s": images / (t1 - t0)},
        attempted=steps, failed=0 if finite else steps,
        memory_peak=_peak(ctx),
        answers={"calls": answers, "cycle": cycle, "bn_stats": stats0},
        items_traced=ctx.tracer.items if ctx.tracer is not None else 0,
        spans={"evaluator.add_batch": spans},
        notes={"window_start": t0, "steps": steps,
               "graph_calls": phases[-1].get("graph_calls"),
               "quarter_rates": window.quarter_rates(t1),
               "evaluator_ms_median": 1e3 * float(np.median(spans))
               if spans else None})
    del trainer
    _free()
    return out


def artifact_dir() -> Path:
    """Where the served artifact is written: under ``TMPDIR``, or inside
    the checkout where no ``TMPDIR`` is set (never a fixed path outside)."""
    tmp = os.environ.get("TMPDIR")
    if tmp:
        return Path(tmp) / "perfbench"
    return Path(__file__).resolve().parents[1] / "build" / "perfbench" / "tmp"


def serve(ctx: Ctx) -> Outcome:
    from centernet_uda_torch import export
    from centernet_uda_torch import models

    cfg = _compose(ctx)
    ref = ctx.config["reference"]
    size = int(ctx.mix["input_size"])
    batch = gen.batch_size(ctx.mix, ref["batch_size"])
    w = _weights(ctx, size)
    stats0 = bn_stats(w)
    params = cfg.model.backend.params.to_dict()
    params.setdefault("dcn_impl", str(cfg.get("dcn_impl", "auto")))
    params["pretrained"] = None
    backend = models.build(cfg.model.backend.name, **params,
                           seed=int(cfg.get("seed", 42)),
                           dtype=torch.float32, device=ctx.device)
    backend.module.load_state_dict(w)
    del w
    backend.module.eval()
    serving = export.ServingModule(backend, int(cfg.max_detections))
    program = export.export_program(serving, (batch, 3, size, size))
    folder = artifact_dir()
    folder.mkdir(parents=True, exist_ok=True)
    path = export.export_pt2(program, folder / ctx.workload)
    del program, serving, backend
    _free()
    module = export.load_artifact(path).module()
    if ctx.patch is not None:
        module = ctx.patch(module)
    n = int(ctx.mix["cycle"])
    images = gen.images(ctx.seed, 1, n * batch, size, ctx.device)
    with torch.no_grad():
        for i in range(int(ctx.mix.get("warmup_calls", 3))):
            module(images[i % n * batch:(i % n + 1) * batch])
    ctx.sync()
    sample = Reservoir(int(ctx.mix.get("sample", 16)), ctx.seed)
    times: List[float] = []
    tracer = ctx.tracer
    t0 = time.perf_counter()
    i = 0
    while True:
        start = time.perf_counter()
        elapsed = start - t0
        if elapsed >= ctx.seconds:
            break
        if tracer is not None:
            tracer.tick(elapsed, ctx.sync)
            tracer.count(1)
            start = time.perf_counter()
        j = i % n
        with _record("perfbench.serve.call"), torch.no_grad():
            boxes, scores, classes = module(
                images[j * batch:(j + 1) * batch])
        with _record("perfbench.serve.sync"):
            ctx.sync()
        times.append(time.perf_counter() - start)
        slot = sample.slot()
        if slot is not None:
            sample.items[slot] = {"image": j * batch, "count": batch,
                                  "dets": {
                "boxes": boxes, "scores": scores, "classes": classes}}
        i += 1
    if tracer is not None:
        tracer.stop(ctx.sync)
    out = Outcome(
        e2e={"serve_ms_p95": 1e3 * p95(times)},
        attempted=len(times), failed=0, memory_peak=_peak(ctx),
        answers={"calls": list(sample.items.values()), "images": images,
                 "bn_stats": stats0},
        items_traced=tracer.items if tracer is not None else 0,
        notes={"window_start": t0, "calls": len(times),
               "ms_median": 1e3 * float(np.median(times)) if times else None,
               "quarter_ms_median": [
                   1e3 * float(np.median(times[q * len(times) // 4:
                                               (q + 1) * len(times) // 4]))
                   for q in range(4) if len(times) >= 4]})
    del module
    _free()
    return out


def p95(values: List[float]) -> float:
    """The 95th percentile of all values, by nearest rank: the smallest
    value with at least 95 % of the values at or below it."""
    if not values:
        return float("nan")
    ordered = sorted(values)
    rank = max(1, -(-95 * len(ordered) // 100))
    return ordered[rank - 1]


ENTRIES = {"train": train, "eval": eval, "serve": serve}
