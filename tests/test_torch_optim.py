"""The port's optimizer and schedule against the JAX package's: Adam with
coupled weight decay (torch.optim.Adam(weight_decay)) against the optax
chain ``make_optimizer`` builds, over steps with identical gradients and a
learning-rate change between them; MultiStepLR. float32 both sides, 1e-6."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from centernet_uda_tpu.utils import optim as jo
from centernet_uda_torch.utils import optim as to

torch.set_num_threads(2)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4, 0.1])
def test_adam_matches_optax_chain(weight_decay):
    rng = np.random.RandomState(0)
    p0 = rng.randn(5, 4).astype(np.float32)
    grads = [rng.randn(5, 4).astype(np.float32) for _ in range(6)]
    cfg = {"lr": 1e-2, "weight_decay": weight_decay}

    tx = jo.make_optimizer("Adam", cfg)
    params = {"w": jnp.asarray(p0)}
    state = tx.init(params)
    param = torch.nn.Parameter(torch.tensor(p0))
    opt = to.make_optimizer("Adam", cfg, [param])
    for i, g in enumerate(grads):
        if i == 3:  # an epoch boundary: both take a new learning rate
            jo.set_learning_rate(state, 1e-3)
            to.set_learning_rate(opt, 1e-3)
        updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
        param.grad = torch.tensor(g)
        opt.step()
        np.testing.assert_allclose(param.detach().numpy(),
                                   np.asarray(params["w"]), rtol=1e-6,
                                   atol=1e-6, err_msg=f"step {i}")
    assert opt.param_groups[0]["lr"] == pytest.approx(
        jo.get_learning_rate(state))


def test_multistep_lr_matches_jax():
    jsched = jo.make_scheduler("MultiStepLR", {"milestones": [30, 60],
                                               "gamma": 0.1})
    tsched = to.make_scheduler("MultiStepLR", {"milestones": [60, 30],
                                               "gamma": 0.1})
    for epoch in range(0, 95, 5):
        assert tsched.lr(epoch, 5e-5) == pytest.approx(jsched.lr(epoch, 5e-5))


def test_unported_names_raise():
    with pytest.raises(KeyError):
        to.make_optimizer("SGD", {"lr": 0.1}, [torch.nn.Parameter(
            torch.zeros(1))])
    with pytest.raises(KeyError):
        to.make_scheduler("CosineAnnealingLR", {"T_max": 3})
    assert to.make_scheduler(None) is None
