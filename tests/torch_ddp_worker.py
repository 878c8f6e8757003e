"""One rank of a data-parallel train run on the CPU, for
``tests/test_torch_parallel.py``.

    python tests/torch_ddp_worker.py RANK WORLD PORT SPEC.json

``SPEC.json`` holds the config overrides, the path of an ``.npz`` of
global batches (``<step>/<key>`` arrays, rows the global batch) and the
output path. The backend computes in float64 (parameters, BatchNorm
statistics and every layer; the losses stay float32), so that what the
ranks change shows apart from float32 summation order. The rank joins a gloo group of ``WORLD`` ranks (none for
``WORLD`` 0, the single-process reference), builds the trainer, takes one
train step per batch on its rows ``rank * b .. (rank + 1) * b`` (all of them
without a group), and rank 0 saves the stats of every step and the
parameters before and after the steps (backend with its BatchNorm
statistics, and the discriminator where the trainer has one) with
``torch.save``. It imports neither JAX nor the JAX package.

With ``"graphs": true`` in the spec the trainer's steps go through
``StepGraphs`` with the CPU stand-in of a CUDA graph
(``tests/torch_graph_stand_in.py``). With ``"events": true`` the run also
meets the three events that drop the graphs, each after the step named in
``EVENTS``: a degrade forced through rank 0's own ``dcn_max_abs_dy`` (the
other ranks report 0; every rank degrades on the maximum, as ``train.py``
reads it), a MultiStepLR milestone (``epoch_end``), and a ``load_model`` of
a checkpoint each rank writes; every rank then saves its graph counts,
rank r > 0 to ``<out>.<r>``.
"""

import json
import sys

import numpy as np
import torch


# step after which each event happens (``"events": true``)
EVENTS = {1: "degrade", 3: "learning_rate", 5: "load_model"}


def batches(path):
    data = np.load(path)
    steps = sorted({int(k.split("/")[0]) for k in data.files})
    return [{k.split("/", 1)[1]: data[k] for k in data.files
             if k.startswith(f"{s}/")} for s in steps]


def state(trainer):
    params = {f"backend.{k}": v.detach().clone() for k, v in
              trainer.backend.module.state_dict().items()}
    disc = getattr(trainer, "discriminator", None)
    if disc is not None:
        params.update({f"disc.{k}": v.detach().clone()
                       for k, v in disc.state_dict().items()})
    return params


def forced_dy(ddp, rank, steps):
    """``ddp.reduce_stats`` that first sets this rank's ``dcn_max_abs_dy``:
    the kernels' clamp on rank 0 at the degrade's step, else 0."""
    from centernet_uda_torch.ops.dcn import PALLAS_MAX_SHIFT

    reduce = ddp.reduce_stats
    degrade = next(s for s, e in EVENTS.items() if e == "degrade")

    def reduce_stats(stats):
        dy = PALLAS_MAX_SHIFT if rank == 0 and len(steps) == degrade else 0.0
        return reduce({**stats, "dcn_max_abs_dy": torch.tensor(float(dy))})

    return reduce_stats


def meet(trainer, event, stats, path):
    """One of ``EVENTS`` on ``trainer``, after a step that returned
    ``stats``."""
    if event == "degrade":
        trainer.maybe_degrade_dcn(float(stats["dcn_max_abs_dy"]))
    elif event == "learning_rate":
        milestone = trainer.scheduler.milestones[0]
        trainer.epoch = milestone - 1
        trainer.epoch_end()
    else:
        trainer.save_model(path, trainer.epoch, with_optimizer=True)
        trainer.load_model(path, resume=True)


def run(rank: int, world: int, port: int, spec: dict) -> None:
    from pathlib import Path

    from centernet_uda_torch.config import compose
    from centernet_uda_torch.parallel import ddp
    from centernet_uda_torch.train import build_trainer
    from tests.torch_graph_stand_in import stand_in_graphs

    torch.set_num_threads(1)
    reduce_stats = ddp.reduce_stats
    if world:
        ddp.init(ddp.Ranks(rank=rank, world=world, local_rank=rank,
                           local_world=world, port=port),
                 torch.device("cpu"))
    try:
        trainer = build_trainer(compose(spec["overrides"]), device="cpu")
        net = trainer.backend.module.double()
        for mod in net.modules():
            if hasattr(mod, "compute_dtype"):
                mod.compute_dtype = torch.float64
        trainer.init_done()
        if spec.get("graphs"):
            stand_in_graphs(trainer)
        initial = state(trainer)
        stats = []
        if spec.get("events"):
            ddp.reduce_stats = forced_dy(ddp, rank, stats)
            ckpt = Path(spec["out"]).parent / f"rank{rank}" / "model.ckpt"
            ckpt.parent.mkdir(exist_ok=True)
        for data in batches(spec["batches"]):
            data = {k: v.astype(np.float64) if "input" in k else v
                    for k, v in data.items()}
            if world:
                b = len(data["input"]) // world
                data = {k: v[rank * b:(rank + 1) * b]
                        for k, v in data.items()}
            out = trainer.step(data, is_training=True)["stats"]
            stats.append({k: float(v) for k, v in out.items()})
            if spec.get("events") and len(stats) - 1 in EVENTS:
                meet(trainer, EVENTS[len(stats) - 1], out, ckpt)
        graphs = trainer.step_graphs
        result = {"stats": stats, "initial": initial,
                  "params": state(trainer),
                  "graphs": None if graphs is None else {
                      "generation": graphs.generation,
                      "calls": dict(graphs.calls)}}
        if rank == 0:
            torch.save(result, spec["out"])
        elif spec.get("events"):
            torch.save(result, f"{spec['out']}.{rank}")
    finally:
        ddp.reduce_stats = reduce_stats
        ddp.shutdown()


if __name__ == "__main__":
    rank, world, port = (int(a) for a in sys.argv[1:4])
    with open(sys.argv[4]) as f:
        run(rank, world, port, json.load(f))
