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
"""

import json
import sys

import numpy as np
import torch


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


def run(rank: int, world: int, port: int, spec: dict) -> None:
    from centernet_uda_torch.config import compose
    from centernet_uda_torch.parallel import ddp
    from centernet_uda_torch.train import build_trainer

    torch.set_num_threads(1)
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
        initial = state(trainer)
        stats = []
        for data in batches(spec["batches"]):
            data = {k: v.astype(np.float64) if "input" in k else v
                    for k, v in data.items()}
            if world:
                b = len(data["input"]) // world
                data = {k: v[rank * b:(rank + 1) * b]
                        for k, v in data.items()}
            out = trainer.step(data, is_training=True)["stats"]
            stats.append({k: float(v) for k, v in out.items()})
        if rank == 0:
            torch.save({"stats": stats, "initial": initial,
                        "params": state(trainer)}, spec["out"])
    finally:
        ddp.shutdown()


if __name__ == "__main__":
    rank, world, port = (int(a) for a in sys.argv[1:4])
    with open(sys.argv[4]) as f:
        run(rank, world, port, json.load(f))
