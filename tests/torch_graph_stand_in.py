"""A CUDA graph's behaviour on the CPU, for the compiled-step tests
(``tests/test_torch_step_graphs.py``, ``tests/torch_ddp_worker.py``).

A CUDA graph needs a card, so ``StepGraphs`` gets a stand-in for it here
(``StandInGraph``): capture runs the step once and puts back every state
tensor it changed and every generator it drew from (a real capture records
and runs nothing, and leaves a registered generator's host state alone),
and a replay runs the step again on the static inputs, drawing from the
generators as they stand, writes its results into the captured outputs and
puts the launch counters back (a real replay runs no Python). It imports
neither JAX nor the JAX package.
"""

import torch

from centernet_uda_torch.utils.graphs import StepGraphs, map_tensors


class StandInGraph:
    """A CUDA graph's behaviour on the CPU (see the module docstring).
    ``generators`` are those the step draws from, ``state()`` gives the
    tensors a step updates in place; ``counters`` the launch counters a
    replay must leave alone."""

    def __init__(self, generators=(), state=lambda: (), counters=None):
        self.generators = tuple(generators)
        self.state = state
        self.counters = counters
        self.fn = self.outputs = None

    def capture(self, fn):
        tensors = list(self.state())
        saved = [t.detach().clone() for t in tensors]
        drawn = [g.get_state() for g in self.generators]
        self.fn = fn
        self.outputs = fn()
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)
        for g, st in zip(self.generators, drawn):
            g.set_state(st)
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
        "cpu", graph_factory=lambda generators: StandInGraph(
            generators, lambda: state_of(trainer), counters),
        counters={} if counters is None else counters)
    return trainer.step_graphs
