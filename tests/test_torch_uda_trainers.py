"""The port's entropy-minimization and max-squares trainers against the JAX
package's, from one bridged init (``tests/test_torch_uda_twins.py``): a narrow DLA at
64 px, batch 2, ``dcn_impl: xla`` on both sides, the UDA weight raised to
1.0.

Per step, over three steps, every stat within 1e-3 relative (the baseline
slice's tolerance: Adam's first steps amplify f32 gradient noise; the
twins' docstring says why their lr is 1e-4). After the first step, every
BatchNorm running statistic, which both train-mode forwards updated,
source first, within 1e-4 relative of the JAX package's ``batch_stats``.
Then the eval step, on the JAX state bridged into the port, within 1e-4.
"""

import pytest
import torch

from centernet_uda_torch.uda.entropy_minimization import EntropyMinimization
from centernet_uda_torch.uda.max_squares_minimization import (
    MaxSquaresMinimization,
)
from tests import test_torch_uda_twins as tw

torch.set_num_threads(2)

SIZE = 64
METHODS = {
    "entropy_minimization": (
        EntropyMinimization, "entropy_loss",
        "model.uda.EntropyMinimization.entropy_weight=1.0"),
    "max_squares_minimization": (
        MaxSquaresMinimization, "max_square_loss",
        "model.uda.MaxSquaresMinimization.max_squares_weight=1.0"),
}


@pytest.fixture(scope="module", params=sorted(METHODS))
def run(request):
    cls, uda_stat, weight = METHODS[request.param]
    out = tw.run_trainer(request.param, SIZE, weight)
    assert type(out["port"]) is cls
    return {**out, "uda_stat": uda_stat}


@pytest.mark.parametrize("step", [0, 1, 2])
def test_stats_match_jax(run, step):
    tw.check_stats(run, step, run["uda_stat"])


def test_batchnorm_statistics_match_jax_after_one_step(run):
    tw.check_batchnorm(run["first"])


def test_eval_step_matches_jax(run):
    tw.check_eval(run)
