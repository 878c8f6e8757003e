"""Data parallelism: one process (rank) per device, gradients summed.

Counterpart of ``centernet_uda_tpu/parallel/mesh.py`` (``MeshContext``: the
batch sharded over a ``data`` mesh axis, parameters replicated, XLA's
all-reduces). The port runs one process per device and computes, across
its ranks, what the JAX package computes over the whole batch:

- ``batch_size`` is the batch of one host, split evenly over that host's
  ranks; rank r holds rows ``r * b .. (r + 1) * b`` of each global batch
  (``data/loader.py`` shards each batch, not the epoch).
- Each rank's loss is its share of the loss of the global batch: a
  normalizer that counts over the batch (the focal loss's positives, the
  L1 masks) is summed over the ranks (``global_sum``), a mean divides by
  the rank count too (``rank_share``). The shares add up to the
  single-device loss, so the gradients summed over the ranks
  (``sum_gradients``, an explicit all-reduce after the backward) are its
  gradient, for the UDA trainers' two optimizers too (ADVENT's two
  ``backward(inputs=...)`` calls are not what DDP's reducer takes).
- BatchNorm statistics over groups of the global batch
  (``models/common.py``, ``bn_sync``) gather per-sample moments across the
  ranks (``gather_rows``, differentiable).
- Training stats are reduced over the ranks (``reduce_stats``); eval
  detections are gathered to rank 0 (``gather_to_main``), which alone runs
  the evaluators and writes checkpoints, logs and ``config.yaml``.

On the card the steps' collectives (``global_sum``, ``gather_rows``,
``sum_gradients``) run inside the steps' CUDA graphs (``utils/graphs.py``):
each is enqueued on the step's stream, waits for nothing on the host, and
reads no host value but the rank and the world size, which a graph keeps
as constants, and which parameters have a gradient, which a step's graph
fixes too. ``reduce_stats`` runs after the step, outside its graph
(``uda/base.py`` says why).

Ranks come from a launcher (``torchrun``: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), or
``train.main`` starts them itself where ``mesh: {data: N}`` or ``gpu: [..]``
asks for N and N devices are visible, or, where nothing asks, one per
visible card when more than one is visible and ``batch_size`` divides over
them (``plan_ranks``, the JAX package's auto mesh). The backend is NCCL on
the card and gloo on the CPU.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# how long a collective waits for the other ranks before the run fails
# (rank 0 evaluates and writes checkpoints while the others wait)
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=30)

# training stats reduced by their maximum over the ranks, not their sum
MAX_STATS = ("dcn_max_abs_dy",)


@dataclass
class Ranks:
    """One process's place among the ranks of a run."""

    rank: int
    world: int
    local_rank: int
    local_world: int
    addr: str = "127.0.0.1"
    port: int = 29500


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def is_main() -> bool:
    return rank() == 0


def requested_ranks(cfg) -> int:
    """The data-parallel degree the config asks for: ``mesh.data``, else
    the length of a ``gpu`` list (the reference's DataParallel switch);
    0 for neither."""
    mesh = cfg.get("mesh")
    n = int(mesh.get("data", 0) or 0) if mesh else 0
    gpu = cfg.get("gpu")
    if not n and isinstance(gpu, (list, tuple)):
        n = len(gpu)
    return n


def plan_ranks(cfg, device: torch.device) -> Tuple[int, Optional[str]]:
    """The ranks this host runs for ``cfg`` on ``device``'s kind and why
    not the ones asked for: ``(n, None)`` for the ``n`` asked for, or
    ``(0, warning)`` where fewer devices are visible than asked or
    ``batch_size`` does not divide (the JAX package's messages,
    ``centernet_uda_tpu/train.py``). Where that leaves 0, every visible
    device takes a rank if more than one is visible and ``batch_size``
    divides over them (``_should_auto_mesh`` there); else the run trains
    on one device. The CPU counts as one device."""
    n = requested_ranks(cfg)
    available = (torch.cuda.device_count() if device.type == "cuda" else 1)
    batch_size = int(cfg.get("batch_size", 1))
    why_not = None
    if n > available:
        n, why_not = 0, (f"requested {n}-way data parallelism but only "
                         f"{available} device(s) available")
    elif n and batch_size % n != 0:
        n, why_not = 0, (f"batch_size {cfg.get('batch_size')} is not "
                         f"divisible by the {n}-way data mesh")
    if not n and available > 1 and batch_size % available == 0:
        n = available
    if why_not is not None:
        why_not += (f"; running on the {n} visible devices" if n
                    else "; running single-device")
    return n, why_not


def launched_ranks() -> Optional[Ranks]:
    """The ranks a launcher (``torchrun``) put in the environment, or
    None."""
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return None
    world = int(env["WORLD_SIZE"])
    return Ranks(rank=int(env["RANK"]), world=world,
                 local_rank=int(env.get("LOCAL_RANK", env["RANK"])),
                 local_world=int(env.get("LOCAL_WORLD_SIZE", world)),
                 addr=env.get("MASTER_ADDR", "127.0.0.1"),
                 port=int(env.get("MASTER_PORT", 29500)))


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(n: int, argv: Sequence[str]) -> Tuple[Ranks, List]:
    """Start ranks 1..n-1 of an n-rank run on this host, each a process
    running ``python -m centernet_uda_torch.train`` on ``argv``; the caller
    is rank 0. Returns rank 0's ``Ranks`` and the processes."""
    ranks = Ranks(rank=0, world=n, local_rank=0, local_world=n,
                  port=free_port())
    root = str(Path(__file__).resolve().parents[2])
    path = os.environ.get("PYTHONPATH")
    procs = []
    for r in range(1, n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR=ranks.addr, MASTER_PORT=str(ranks.port),
                   PYTHONPATH=root + (os.pathsep + path if path else ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "centernet_uda_torch.train", *argv],
            env=env))
    return ranks, procs


def stop_ranks(procs) -> None:
    """Kill the spawned ranks that still run."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def join_ranks(procs, timeout_s: float) -> None:
    """Wait for spawned ranks; kill them all if one fails or the wait
    times out, and raise."""
    try:
        for p in procs:
            if p.wait(timeout=timeout_s) != 0:
                raise RuntimeError(f"rank process {p.args} exited with "
                                   f"{p.returncode}")
    finally:
        stop_ranks(procs)


def init(ranks: Ranks, device: torch.device) -> None:
    """Join the run's process group: NCCL for a CUDA device (set as the
    current device), gloo for the CPU."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{ranks.addr}:{ranks.port}", rank=ranks.rank,
        world_size=ranks.world, timeout=COLLECTIVE_TIMEOUT)


def shutdown() -> None:
    if is_distributed():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# collectives of the train and eval steps
# ---------------------------------------------------------------------------


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, without a gradient: a loss's
    normalizer. ``t`` itself on one process."""
    if not is_distributed():
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def rank_share(local_mean: torch.Tensor) -> torch.Tensor:
    """This rank's share of a mean over the global batch, from its mean over
    its own rows (every rank holds as many): the local mean over the rank
    count. ``local_mean`` itself on one process."""
    return local_mean / world_size() if is_distributed() else local_mean


class _GatherRows(torch.autograd.Function):
    """All ranks' (b, ...) tensors stacked in rank order; the backward sums
    the gradient over the ranks and takes this rank's rows."""

    @staticmethod
    def forward(ctx, t):
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t.contiguous())
        ctx.rows = t.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g)
        first = dist.get_rank() * ctx.rows
        return g[first:first + ctx.rows]


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t`` in rank order (differentiable); ``t``
    itself on one process."""
    return _GatherRows.apply(t) if is_distributed() else t


def sum_gradients(optimizers: Sequence[torch.optim.Optimizer]) -> None:
    """Sum the gradients of the optimizers' parameters over the ranks, in
    one all-reduce."""
    if not is_distributed():
        return
    grads = [p.grad for opt in optimizers for group in opt.param_groups
             for p in group["params"] if p.grad is not None]
    if not grads:
        return
    flat = torch._utils._flatten_dense_tensors(grads)
    dist.all_reduce(flat)
    for g, summed in zip(grads, torch._utils._unflatten_dense_tensors(
            flat, grads)):
        g.copy_(summed)


def reduce_stats(stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A step's stats over the ranks: the loss shares summed (the global
    batch's losses), ``MAX_STATS`` by their maximum."""
    if not is_distributed() or not stats:
        return stats
    keys = sorted(stats)
    summed = [k for k in keys if k not in MAX_STATS]
    maxed = [k for k in keys if k in MAX_STATS]
    out = {}
    for names, op in ((summed, dist.ReduceOp.SUM), (maxed, dist.ReduceOp.MAX)):
        if not names:
            continue
        t = torch.stack([torch.as_tensor(stats[k]).float() for k in names])
        dist.all_reduce(t, op=op)
        out.update(zip(names, t.unbind()))
    return out


def broadcast_from_main(obj):
    """Rank 0's ``obj`` on every rank; ``obj`` itself on one process."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def gather_to_main(obj) -> Optional[List]:
    """Every rank's ``obj`` in rank order on rank 0 (None elsewhere);
    ``[obj]`` on one process."""
    if not is_distributed():
        return [obj]
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, obj)
    return parts if is_main() else None
