"""Compiled steps: CUDA graphs captured once per input signature.

The counterpart of the JAX package's jitted step functions
(``centernet_uda_tpu/uda/base.py:_build_step_fns``: ``jax.jit(train_step,
donate_argnums=(0,))``, ``jax.jit(eval_step)``, ``jax.jit(decode)``), where
XLA runs a whole step as one program. ``StepGraphs`` does the same for a
step on the card: it records the step's kernels once into a
``torch.cuda.CUDAGraph`` and replays them, so a step costs one launch from
the host instead of one per op. The state a step updates (parameters,
BatchNorm statistics, optimizer moments) is updated in place, as donated
buffers are in the JAX package.

A call ``graphs(name, fn, inputs)`` runs ``fn(inputs)``, ``inputs`` a dict
of tensors, keyed by ``name`` (train, eval, decode, ...), the inputs'
signature (key, shape, dtype and device of each tensor) and a generation
number:

- the first call of a key runs ``fn`` eagerly on the inputs moved to the
  device: a real step, which also creates what capture cannot (the
  optimizer's state, cuBLAS/cuDNN workspaces, cuFFT plans, the kernels'
  shared-memory attributes);
- the second copies the inputs into static buffers, captures ``fn`` on them
  (capture records and runs nothing, so the step count and the trajectory
  are the eager ones) and replays the graph once;
- every later call copies the inputs into the static buffers and replays.

What a call returns is a copy of the graph's outputs taken after the
replay, so outputs held from one call are not overwritten by the next (a
train step's stats, eval heads, detections).

``invalidate()`` drops every graph (a new generation): the trainer calls it
where the JAX package rebuilds its step functions, and where a captured
constant changes (a float learning rate, the DCN route, an optimizer's
state tensors replaced by a checkpoint).

Launch accounting: a graph's replay runs no Python, so the kernel
wrappers' counters (``ops.dcn_cuda.LAUNCHES``, ``ops.batchnorm.LAUNCHES``,
``ops.depthwise.LAUNCHES``) would not move. Capture runs the wrappers once
without launching anything; the helper takes that count back off and adds
it again on every replay, so the counts per step are exact.

Random draws: a step that draws from a ``torch.Generator`` of its own
(EfficientNet's stochastic depth) names it in ``generators``; the graph
registers it before capture (``CUDAGraph.register_generator_state``), so a
replay reads the generator's seed and offset as they stand on the host at
that replay and advances the offset as an eager call would. A generator
reseeded before every call (``manual_seed``) thus gives a replay the draws
of an eager call after the same seed.

Collectives: under a process group the steps' NCCL collectives (the loss
normalizers' and the gradients' all-reduces, grouped BatchNorm's
all-gather) are captured and replayed like any kernel. The communicator
is created by the first collective, which the first (eager) call of a
signature runs, never a capture. Every call runs each of its collectives
once, whether eager, captured and replayed, or replayed, so the ranks stay
in step as long as they drop their graphs at the same call
(``uda/base.py``).

Garbage collection: a CUDA graph freed during another graph's capture
destroys itself with calls that capture forbids, and that invalidates the
capture (torch only warns from the destructor; the capture fails at its
end). A dropped trainer's graphs wait for the cyclic collector where the
trainer sits in a reference cycle, and a collection can start at any
allocation, so ``CudaGraph.capture`` collects first and keeps the
collector off until the capture ends.

Captures of one ``StepGraphs`` share one memory pool. They run with
``capture_error_mode="thread_local"``: the loader's thread pins host
memory while a step is captured, which the global mode forbids process-wide
(the DCN wrappers' host calls are legal under the global mode too;
``tests/test_torch_gpu.py`` captures them so). A capture or a replay
that fails raises; nothing falls back to the eager step.
``graph_factory(generators)`` makes the graph object (``capture(fn)``
returning fn's outputs, ``replay()``); the default is a CUDA graph, and
the CPU tests inject a stand-in.

Spans (``utils/spans.py``; in a profiler's trace only): ``graphs.eager``
(a key's first, eager call), ``graphs.capture`` (staging and capture),
``graphs.stage`` (a replay's inputs copied into the static buffers) and
``graphs.replay`` (the replay and the outputs' copies). A
``graphs.eager`` or ``graphs.capture`` event in a steady stretch of a
trace is a step built again (after ``invalidate()``, or a new input
signature); ``calls`` counts the same events.
"""

from __future__ import annotations

import gc
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from centernet_uda_torch.ops import batchnorm, dcn_cuda, depthwise
from centernet_uda_torch.utils.spans import span


class CudaGraph:
    """A ``torch.cuda.CUDAGraph`` in ``pool`` that draws from
    ``generators`` (registered before capture), behind the interface
    ``StepGraphs`` calls."""

    def __init__(self, pool, generators: Sequence[torch.Generator] = ()):
        self.graph = torch.cuda.CUDAGraph()
        self.pool = pool
        self.generators = tuple(generators)

    def capture(self, fn: Callable[[], Any]) -> Any:
        for gen in self.generators:
            self.graph.register_generator_state(gen)
        # no graph may be freed inside the capture (module docstring)
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                return fn()
        finally:
            if enabled:
                gc.enable()

    def replay(self) -> None:
        self.graph.replay()


def map_tensors(fn: Callable[[torch.Tensor], Any], tree):
    """``fn`` over every tensor of nested dicts, lists and tuples; other
    leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


def signature(inputs: Dict[str, torch.Tensor]) -> Tuple:
    return tuple((k, tuple(v.shape), v.dtype, v.device.type)
                 for k, v in sorted(inputs.items()))


@dataclass
class _Captured:
    graph: Any
    static: Dict[str, torch.Tensor]
    outputs: Any
    launches: List[Dict[str, int]]


class StepGraphs:
    """Captured steps of one trainer on ``device``, one memory pool."""

    def __init__(self, device, graph_factory: Optional[Callable[
                     [Sequence[torch.Generator]], Any]] = None,
                 counters: Optional[Dict[str, int]] = None):
        self.device = torch.device(device)
        self.graph_factory = graph_factory or self._cuda_graph
        self.counters = ([dcn_cuda.LAUNCHES, batchnorm.LAUNCHES,
                          depthwise.LAUNCHES]
                         if counters is None else [counters])
        self.generation = 0
        self._seen = set()
        self._graphs: Dict[Tuple, _Captured] = {}
        self._pool = None
        # eager warm-ups, captures and replays so far
        self.calls = {"eager": 0, "captures": 0, "replays": 0}

    def _cuda_graph(self, generators: Sequence[torch.Generator]):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return CudaGraph(self._pool, generators)

    def __len__(self) -> int:
        return len(self._graphs)

    def invalidate(self) -> None:
        """Drop every graph: the next call of each key is eager again."""
        self.generation += 1
        self._seen.clear()
        self._graphs.clear()

    def __call__(self, name: str, fn: Callable[[Dict[str, torch.Tensor]],
                                               Any],
                 inputs: Dict[str, torch.Tensor],
                 generators: Sequence[torch.Generator] = ()):
        """``fn(inputs)``: eager, captured or replayed (module docstring);
        returns copies of its outputs on a replay. ``generators``: those
        ``fn`` draws from besides the device's default one."""
        key = (name, self.generation, signature(inputs))
        captured = self._graphs.get(key)
        if captured is None and key not in self._seen:
            self._seen.add(key)
            self.calls["eager"] += 1
            with span("graphs.eager"):
                return fn({k: v.to(self.device, non_blocking=True)
                           for k, v in inputs.items()})
        if captured is None:
            captured = self._capture(key, fn, inputs, generators)
        else:
            with span("graphs.stage"):
                for k, v in inputs.items():
                    captured.static[k].copy_(v, non_blocking=True)
        with span("graphs.replay"):
            captured.graph.replay()
            outputs = map_tensors(torch.clone, captured.outputs)
        self.calls["replays"] += 1
        for counts, launches in zip(self.counters, captured.launches):
            for k, n in launches.items():
                counts[k] += n
        return outputs

    def _capture(self, key, fn, inputs, generators) -> _Captured:
        with span("graphs.capture"):
            static = {k: torch.empty(v.shape, dtype=v.dtype,
                                     device=self.device)
                      for k, v in inputs.items()}
            for k, v in inputs.items():
                static[k].copy_(v, non_blocking=True)
            graph = self.graph_factory(generators)
            before = [dict(counts) for counts in self.counters]
            outputs = graph.capture(lambda: fn(static))
        launches = [{k: n - was.get(k, 0) for k, n in counts.items()
                     if n != was.get(k, 0)}
                    for counts, was in zip(self.counters, before)]
        for counts, taken in zip(self.counters, launches):
            for k, n in taken.items():
                counts[k] -= n
        captured = _Captured(graph, static, outputs, launches)
        self._graphs[key] = captured
        self.calls["captures"] += 1
        return captured
