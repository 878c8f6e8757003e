"""Trainer assembly and the training CLI.

    python -m centernet_uda_torch.train experiment=baseline [key=value ...]
        [--device cuda|cpu]

Counterpart of ``centernet_uda_tpu/train.py``. ``build_trainer`` assembles
backend, loss, trainer (the baseline, or the UDA method named by the first
key of ``model.uda``), optimizer and schedule
through the registries, on ``device``, at ``precision`` float32 or bfloat16.
``main`` composes the config from the checkout's ``configs/`` tree
(defaults, the ``experiment=<name>`` overlay, then ``key=value``
overrides), builds the trainer, the datasets and loaders, the evaluators
and the TensorBoard logger, and runs the epoch loop: a training phase,
then every ``eval_at_n_epoch`` epochs a validation phase with COCO
evaluation and the last/best checkpoints, then the test split if the
config has one. Outputs go to ``outputs/<experiment>/`` under the working
directory, which ``main`` enters (``config.yaml``, ``model_last.ckpt``,
``model_best.ckpt``, ``logs/``, ``profile/``). It runs on the card unless
``device`` (or ``--device``) says ``cpu``.

Data parallelism (``parallel/ddp.py``, the JAX package's device mesh): under
a launcher (``torchrun``, or ``distributed: true`` with its environment)
``main`` joins the launcher's ranks; where ``mesh: {data: N}`` or ``gpu:
[...]`` asks for N ranks and N cards are visible, it starts ranks 1..N-1
itself and runs rank 0. Where fewer devices are visible or ``batch_size``
does not divide, it warns and trains on one device, as the JAX package does.
Each rank takes ``batch_size / ranks`` of each batch of its host; eval
batches are padded (``pad_last``) and their detections gathered to rank 0,
which alone evaluates and writes ``config.yaml``, logs and checkpoints
(under the module's own names). On the card every rank's steps are CUDA
graphs as on one device, their collectives captured inside them
(``uda/base.py``, ``utils/graphs.py``).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from centernet_uda_torch import config as config_lib
from centernet_uda_torch import data as data_registry
from centernet_uda_torch import evaluation as eval_registry
from centernet_uda_torch import losses as loss_registry
from centernet_uda_torch import models as model_registry
from centernet_uda_torch import resolve_device
from centernet_uda_torch import uda as uda_registry
from centernet_uda_torch.data.loader import DataLoader
from centernet_uda_torch.models.common import bn_group_count, set_bn_groups
from centernet_uda_torch.ops.dcn import PALLAS_MAX_SHIFT
from centernet_uda_torch.parallel import ddp
from centernet_uda_torch.uda.base import _HOST_KEYS, Model
from centernet_uda_torch.utils import optim as optim_util
from centernet_uda_torch.utils.meters import AverageMeter
from centernet_uda_torch.utils.spans import span
from centernet_uda_torch.utils.tensorboard import TensorboardLogger

log = logging.getLogger("uda")

# the config's ``precision``: the compute dtype of the backend's layers
# (centernet_uda_tpu/train.py passes ``dtype`` to the model the same way)
PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the shared configs/ tree of this checkout
CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"

# training stats stay on the device and are read in batches of this many
# steps (a read per step would wait for every step to finish)
STATS_FLUSH = 8

# how long rank 0 waits for the ranks it started to exit after its run
RANK_JOIN_TIMEOUT_S = 600


def build_trainer(cfg, device="cuda", graphs: bool = True) -> Model:
    """Assemble backend + loss + optimizer + trainer; call ``init_done()``
    on the result before the first step. Under a process group (``main``)
    the trainer is this rank's, with ``bn_sync`` over the ranks; without
    one, a config asking for data parallelism warns and builds for one
    device. On the card the steps are CUDA graphs (``uda/base.py``);
    ``graphs=False`` gives the eager steps."""
    device = resolve_device(device)
    precision = str(cfg.get("precision", "float32"))
    if precision not in PRECISIONS:
        raise NotImplementedError(
            f"precision {precision!r} is not ported (only "
            f"{sorted(PRECISIONS)})")
    # float32 means float32, in both modes (bfloat16 keeps its BatchNorm,
    # loss and optimizer in float32): no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one seed, one trajectory, as the JAX package gives: the DCN kernels
    # repeat bit for bit, and cuDNN keeps to its deterministic algorithms
    # (a float32 convolution's backward otherwise may take one that adds
    # with atomics; where the deterministic one is slow, the models' Conv2d
    # takes its gradient by a route of ops/conv.py)
    torch.backends.cudnn.deterministic = True
    if not ddp.is_distributed():
        n_ranks, why_not = ddp.plan_ranks(cfg, device)
        if why_not:
            log.warning(why_not)
        if n_ranks > 1:
            log.warning("%d-way data parallelism starts its ranks through "
                        "main() or torchrun; this trainer runs in one "
                        "process", n_ranks)
    bn_groups = bn_group_count(cfg.get("bn_sync", "global"),
                               ddp.world_size())

    backend_params = cfg.model.backend.params.to_dict()
    backend_params.setdefault("dcn_impl", str(cfg.get("dcn_impl", "auto")))
    backend_params.setdefault("dtype", PRECISIONS[precision])
    backend = model_registry.build(cfg.model.backend.name, **backend_params,
                                   seed=int(cfg.get("seed", 42)),
                                   device=device)
    set_bn_groups(backend.module, bn_groups)

    uda_cfg = cfg.model.get("uda")
    if uda_cfg:
        # the first key names the method, its mapping holds the parameters
        method = list(uda_cfg.keys())[0]
        uda_params = uda_cfg[method]
        if hasattr(uda_params, "to_dict"):
            uda_params = uda_params.to_dict()
        trainer = uda_registry.build(method, device=device, graphs=graphs,
                                     **(uda_params or {}))
    else:
        trainer = Model(device=device, graphs=graphs)
    loss_cfg = cfg.model.backend.loss
    loss_params = loss_cfg.get("params")
    trainer.centernet_loss = loss_registry.build(
        loss_cfg.name, **(loss_params.to_dict() if loss_params else {}))
    trainer.cfg = cfg
    trainer.backend = backend
    trainer.optimizer_cfg = cfg.optimizer.to_dict()
    sched_cfg = cfg.optimizer.get("scheduler")
    if sched_cfg:
        trainer.scheduler = optim_util.make_scheduler(
            sched_cfg.get("name"), sched_cfg.get("params", {}))
    return trainer


def load_datasets(cfg, down_ratio: int, rotated_boxes: bool,
                  pin_memory: bool = False, full_batches_only: bool = False,
                  batch_size: Optional[int] = None, shard_id: int = 0,
                  num_shards: int = 1):
    """Build train/val/test loaders with merged defaults (train.py:17-67).

    The final partial eval batch runs as it is; with ``full_batches_only``
    (data parallelism) it is padded by repeating samples and carries
    ``_num_real``, and ``_run_phase`` slices the detections back to the
    real samples. ``pin_memory``: the loaders hand over pinned tensors (the
    trainer's host keys stay numpy). ``batch_size`` (default the config's)
    is this process's batch; rank ``shard_id`` of ``num_shards`` loads its
    shard.
    """
    defaults = {
        "max_detections": cfg.max_detections,
        "down_ratio": down_ratio,
        "rotated_boxes": rotated_boxes,
        "num_classes": cfg.model.backend.params.num_classes,
        "num_keypoints": cfg.model.backend.params.get("num_keypoints", 0),
        "mean": list(cfg.normalize.mean),
        "std": list(cfg.normalize.std),
    }

    def build_loader(section, shuffle, drop_last, pad_last=False):
        params = {**section.params.to_dict(), **defaults}
        dataset = data_registry.build(section.name, **params)
        loader = DataLoader(
            dataset,
            batch_size=int(batch_size or cfg.batch_size),
            shuffle=shuffle,
            num_workers=int(cfg.get("num_workers", 0)),
            worker_mode=str(cfg.get("worker_mode", "thread")),
            drop_last=drop_last,
            pad_last=pad_last,
            seed=int(cfg.get("seed", 42)),
            pin_memory=pin_memory,
            host_keys=_HOST_KEYS,
            shard_id=shard_id,
            num_shards=num_shards,
        )
        return dataset, loader

    val_ds, val_loader = build_loader(cfg.datasets.validation, False, False,
                                      pad_last=full_batches_only)
    log.info("Found %d samples in validation dataset", len(val_ds))

    train_ds, train_loader = build_loader(cfg.datasets.training, True, True)
    log.info("Found %d samples in training dataset", len(train_ds))

    test_loader = None
    if "test" in cfg.datasets and cfg.datasets.get("test"):
        test_ds, test_loader = build_loader(cfg.datasets.test, False, False,
                                            pad_last=full_batches_only)
        log.info("Found %d samples in test dataset", len(test_ds))

    return train_loader, val_loader, test_loader


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, device: torch.device, steps: int) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    Path("profile").mkdir(exist_ok=True)
    prof.export_chrome_trace("profile/trace.json")
    log.info("wrote profiler trace for %d steps to profile/trace.json", steps)


def _run_phase(trainer, loader, evaluators, tb_logger, stats, epoch, tag,
               is_training, phases, profile_steps=0):
    """One pass over ``loader``; appends the phase's record to ``phases``
    (see ``main``). Under data parallelism the eval detections go to rank
    0's evaluators after the pass."""
    n_batches = 0
    graphs = trainer.step_graphs
    calls0 = None if graphs is None else dict(graphs.calls)
    t0 = time.perf_counter()
    timed: Dict[str, float] = {}  # the record's host seconds, by span
    n_images = 0
    prof = None
    clamp_warned = False
    pending = []  # [(stats_dict_of_device_tensors, n_real)]
    rank_detections = []  # this rank's, gathered to rank 0 after the pass

    def flush_pending():
        nonlocal clamp_warned
        degraded = False
        for dev_stats, n_w in pending:
            for k, v in dev_stats.items():
                log_key = f"{tag}/{k}"
                meter = stats.get(log_key)
                if not isinstance(meter, AverageMeter):
                    meter = AverageMeter(name=k)
                value = float(v)
                meter.update(value, n_w)
                stats[log_key] = meter
                if k == "dcn_max_abs_dy":
                    # AT the clamp: the numbers are already truncating —
                    # switch to the exact DCN op (uda/base.py)
                    degraded |= trainer.maybe_degrade_dcn(value)
                    if (not clamp_warned
                            and value >= 0.9 * PALLAS_MAX_SHIFT):
                        clamp_warned = True
                        log.warning(
                            "DCN vertical offsets reached %.1f px — within "
                            "10%% of the kernels' clamp (max_shift=%d). The "
                            "run switches to the exact DCN op if the clamp "
                            "is hit; consider dcn_impl=xla outright.",
                            value, PALLAS_MAX_SHIFT)
        pending.clear()
        return degraded

    batches = iter(loader)
    while True:
        try:
            with span("phase.batch_wait", timed):
                data = next(batches)
        except StopIteration:
            break
        # torch.profiler trace of the first N train steps of the first
        # epoch (the reference has no tracing at all)
        if (profile_steps and is_training and epoch == 1 and n_batches == 0
                and ddp.is_main()):
            prof = _start_profiler(trainer.device)
        with span("phase.step"):
            outputs = trainer.step(data, is_training=is_training)
        n_batches += 1
        # a padded final eval batch carries the real sample count
        n_real = int(data.get("_num_real", len(data["input"])))
        n_images += n_real
        if prof is not None and n_batches >= profile_steps:
            _stop_profiler(prof, trainer.device, n_batches)
            prof = None

        pending.append((outputs["stats"], n_real))
        if not is_training or len(pending) >= STATS_FLUSH:
            with span("phase.stats_flush"):
                degraded = flush_pending()
            if degraded and not is_training:
                # this batch's outputs were computed on the truncating
                # kernels — recompute on the exact op the degrade just
                # installed so its detections are correct (the truncated
                # stats were already logged; one batch of loss meters is
                # noise, the detections are not)
                with span("phase.step"):
                    outputs = trainer.step(data, is_training=False)

        if not is_training:
            with span("phase.detections"):
                detections = trainer.get_detections(outputs, data)
                if n_real < len(data["input"]):
                    # drop padded duplicates before they reach the evaluator
                    detections = {k: v[:n_real]
                                  for k, v in detections.items()}
            detections["image_shape"] = tuple(data["input"].shape[1:])
            if ddp.is_distributed():
                if n_real:
                    rank_detections.append(detections)
            else:
                with span("phase.add_batch"):
                    for ev in evaluators:
                        ev.add_batch(**detections)
            if tb_logger is not None:
                with span("phase.log_detections", timed):
                    tb_logger.log_detections(data, detections, epoch,
                                             tag=tag)

    if prof is not None:
        _stop_profiler(prof, trainer.device, n_batches)
    if not is_training and ddp.is_distributed():
        for part in ddp.gather_to_main(rank_detections) or []:
            for detections in part:
                with span("phase.add_batch"):
                    for ev in evaluators:
                        ev.add_batch(**detections)

    with span("phase.stats_flush"):
        flush_pending()
    dt = time.perf_counter() - t0
    if n_batches:
        stats[f"{tag}/images_per_sec"] = n_images / dt
    loss = stats.get(f"{tag}/total_loss")
    phases.append({"epoch": epoch, "tag": tag, "steps": n_batches,
                   "images": n_images, "seconds": dt,
                   "loader_wait_s": timed.get("phase.batch_wait", 0.0),
                   "log_detections_s": timed.get("phase.log_detections",
                                                 0.0),
                   "total_loss": loss.avg if loss is not None else None,
                   "graph_calls": None if graphs is None else {
                       k: n - calls0[k] for k, n in graphs.calls.items()}})
    log.info("%s epoch %d: %d steps in %.2f s, %.1f%% of it waiting for "
             "the loader", tag, epoch, n_batches, dt,
             100.0 * phases[-1]["loader_wait_s"] / max(dt, 1e-9))
    return stats


def _run_eval(trainer, loader, evaluators, tb_logger, stats, epoch, tag,
              phases):
    """An eval phase, then its evaluators' results merged into ``stats``;
    the phase's record gets the evaluators' time."""
    stats = _run_phase(trainer, loader, evaluators, tb_logger, stats, epoch,
                       tag, False, phases)
    timed: Dict[str, float] = {}
    with span("phase.evaluate", timed):
        for ev in evaluators:
            stats = {**stats, **ev.evaluate()}
    phases[-1]["evaluate_s"] = timed["phase.evaluate"]
    return stats


def main(argv=None, device: str = "cuda",
         phases: Optional[List[Dict]] = None) -> dict:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` by default); returns the
    last evaluated epoch's scalars.

    ``phases``, when given, receives one record per phase run: ``epoch``,
    ``tag``, ``steps``, ``images``, ``seconds`` (wall time of the phase,
    the device's work included), ``loader_wait_s`` (of it, the time spent
    waiting for the next batch), ``log_detections_s`` (of it, the time
    spent drawing and writing the TensorBoard detection images),
    ``total_loss`` (its meter's mean since the meters were last reset),
    ``graph_calls`` (the phase's compiled-step calls, ``StepGraphs.calls``
    counted over the phase; None where the steps run eagerly) and, for an
    eval phase, ``evaluate_s`` (the evaluators' time after it). The three
    times are the sums of the spans ``phase.batch_wait``,
    ``phase.log_detections`` and ``phase.evaluate``; those and the phase
    loop's other spans (``phase.step``, ``phase.stats_flush``,
    ``phase.detections``, ``phase.add_batch``) mark a ``torch.profiler``
    trace while one records (``utils/spans.py``): ``profile_steps`` writes
    one.
    """
    phases = [] if phases is None else phases
    parser = argparse.ArgumentParser(
        prog="python -m centernet_uda_torch.train",
        description="Train and evaluate a CenterNet detector.")
    parser.add_argument("--device", default=device,
                        help=f"cuda (the default here: {device}) or cpu")
    parser.add_argument("overrides", nargs="*", metavar="key=value",
                        help="hydra-style overrides, e.g. experiment=baseline")
    args = parser.parse_intermixed_args(
        sys.argv[1:] if argv is None else list(argv))
    cfg = config_lib.compose(args.overrides, config_dir=str(CONFIG_DIR))
    device = resolve_device(args.device)

    ranks = ddp.launched_ranks()
    if ranks is None and cfg.get("distributed"):
        raise ValueError(
            "distributed: true joins a launcher's ranks: run it under "
            "torchrun (which sets RANK, WORLD_SIZE, MASTER_ADDR and "
            "MASTER_PORT)")
    procs = []
    if ranks is None:
        # build_trainer warns where the devices cannot take the ranks asked
        n_ranks, _ = ddp.plan_ranks(cfg, device)
        if n_ranks:
            ranks, procs = ddp.spawn_ranks(
                n_ranks, ["--device", args.device, *args.overrides])
    if ranks is not None and device.type == "cuda":
        device = torch.device("cuda", ranks.local_rank)
    try:
        if ranks is not None:
            ddp.init(ranks, device)
        scalars = _train(cfg, device, ranks, phases)
    except BaseException:
        ddp.stop_ranks(procs)
        raise
    finally:
        ddp.shutdown()
    ddp.join_ranks(procs, RANK_JOIN_TIMEOUT_S)
    return scalars


def _train(cfg, device: torch.device, ranks: Optional[ddp.Ranks],
           phases: List[Dict]) -> dict:
    """``main`` after its ranks are set up: this process's run."""
    is_main = ddp.is_main()
    run_dir = config_lib.setup_run_dir(cfg, dump=is_main)
    # anchor user-supplied paths before entering the run dir (hydra leaves
    # relative paths dangling after its chdir; we resolve them instead)
    for key in ("pretrained", "resume"):
        value = cfg.get(key)
        if value and not Path(str(value)).is_absolute():
            cfg[key] = str(Path(str(value)).resolve())
    os.chdir(run_dir)  # hydra-compatible: checkpoints/logs land in the run dir

    logging.basicConfig(
        level=logging.INFO if is_main else logging.WARNING,
        format=("[%(asctime)s][%(name)s][%(levelname)s] - %(message)s"
                if is_main else f"[rank {ddp.rank()}]" "[%(asctime)s]"
                "[%(name)s][%(levelname)s] - %(message)s"),
    )

    np.random.seed(int(cfg.get("seed", 42)))

    trainer = build_trainer(cfg, device=device)
    backend = trainer.backend

    batch_size = int(cfg.batch_size)
    if ranks is not None:
        if batch_size % ranks.local_world:
            raise ValueError(f"batch_size {batch_size} does not divide over "
                             f"the host's {ranks.local_world} ranks")
        batch_size //= ranks.local_world
        log.info("rank %d of %d: batch %d of the host's %d", ranks.rank,
                 ranks.world, batch_size, int(cfg.batch_size))
    train_loader, val_loader, test_loader = load_datasets(
        cfg, down_ratio=backend.down_ratio,
        rotated_boxes=backend.rotated_boxes,
        pin_memory=trainer.device.type == "cuda",
        full_batches_only=ranks is not None, batch_size=batch_size,
        shard_id=ddp.rank(), num_shards=ddp.world_size(),
    )

    # rank 0 alone logs and evaluates
    tb_logger = (TensorboardLogger(cfg, val_loader.dataset.classes)
                 if is_main else None)

    evaluators = []
    for e in (cfg.evaluation if is_main else ()):
        ev_params = cfg.evaluation[e]
        ev_params = ev_params.to_dict() if hasattr(ev_params, "to_dict") else {}
        ev = eval_registry.build(
            e, score_threshold=float(cfg.get("score_threshold", 0.0)), **ev_params
        )
        ev.classes = val_loader.dataset.classes
        ev.num_workers = int(cfg.get("num_workers", 0))
        ev.use_rotated_boxes = bool(backend.rotated_boxes)
        evaluators.append(ev)

    trainer.init_done()

    start_epoch = 1
    if cfg.get("pretrained") and not cfg.get("resume"):
        start_epoch = trainer.load_model(cfg.pretrained)
    elif cfg.get("resume"):
        start_epoch = trainer.load_model(cfg.resume, True)

    stats: dict = {}
    best = float("inf") if cfg.save_best_metric.mode == "min" else -float("inf")
    scalars: dict = {}
    epoch = start_epoch

    if not cfg.get("test_only", False):
        for epoch in range(start_epoch, int(cfg.epochs) + 1):
            stats = _run_phase(
                trainer, train_loader, evaluators, None, stats, epoch,
                "training", True, phases,
                profile_steps=int(cfg.get("profile_steps", 0) or 0),
            )
            log.info(
                "epoch %d training done (loss %.4f, %.1f img/s)",
                epoch,
                stats.get("training/total_loss").avg
                if "training/total_loss" in stats else float("nan"),
                stats.get("training/images_per_sec", 0.0),
            )

            if epoch % int(cfg.get("eval_at_n_epoch", 1)) != 0:
                continue

            stats = _run_eval(trainer, val_loader, evaluators, tb_logger,
                              stats, epoch, "validation", phases)

            scalars = {}
            for k, s in stats.items():
                if isinstance(s, AverageMeter):
                    scalars[k] = s.avg
                    s.reset()
                else:
                    scalars[k] = s
                if tb_logger is not None:
                    tb_logger.log_stat(k, scalars[k], epoch)
            # every rank takes rank 0's (the evaluators') decisions
            scalars = ddp.broadcast_from_main(scalars)

            trainer.epoch_end()
            if is_main:
                tb_logger.reset()
                trainer.save_model("model_last.ckpt", epoch, True)

            metric_name = cfg.save_best_metric.name
            if metric_name not in scalars:
                log.error(
                    "Metric %s not valid, valid values are %s",
                    metric_name, " ".join(map(str, scalars)),
                )
                return scalars

            current = scalars[metric_name]
            if (cfg.save_best_metric.mode == "min" and best > current) or (
                cfg.save_best_metric.mode == "max" and best < current
            ):
                if is_main:
                    trainer.save_model("model_best.ckpt", epoch, True)
                best = current
                log.info(
                    "Save best model with %s of %.4f", metric_name, current
                )

    if test_loader is not None:
        stats = _run_eval(trainer, test_loader, evaluators, tb_logger, stats,
                          epoch, "test", phases)
        for k, s in stats.items():
            value = s.avg if isinstance(s, AverageMeter) else s
            scalars[k] = value
            if tb_logger is not None:
                tb_logger.log_stat(k, value, epoch)
        scalars = ddp.broadcast_from_main(scalars)
        if tb_logger is not None:
            tb_logger.reset()

    return scalars


if __name__ == "__main__":
    main()
