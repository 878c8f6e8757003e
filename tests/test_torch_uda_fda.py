"""The port's FDA trainer against the JAX package's, as
``tests/test_torch_uda_trainers.py`` holds the other two (same twins, same
tolerances), with ``entropy_weight`` 1.0 and ``beta`` 0.1: the config's
circular mask at 64 px then keeps a 6-px quarter-ellipse of the source
amplitude (at its 0.01 it would keep one cell). The source forward sees
the FFT mix, the target forward the raw target, the entropy term has
``eta`` 1.5."""

import pytest
import torch

from centernet_uda_torch.uda.fda import FDA
from tests import test_torch_uda_twins as tw

torch.set_num_threads(2)

SIZE = 64


@pytest.fixture(scope="module")
def run():
    out = tw.run_trainer("fda", SIZE, "model.uda.FDA.entropy_weight=1.0",
                         "model.uda.FDA.beta=0.1")
    port = out["port"]
    assert type(port) is FDA and port.use_circular and port.beta == 0.1
    assert port.entropy_loss.eta == 1.5
    return out


@pytest.mark.parametrize("step", [0, 1, 2])
def test_stats_match_jax(run, step):
    tw.check_stats(run, step, "entropy_loss")


def test_batchnorm_statistics_match_jax_after_one_step(run):
    tw.check_batchnorm(run["first"])


def test_eval_step_matches_jax(run):
    tw.check_eval(run)
