"""The port's optimizers and schedules against the JAX package's: each
optimizer (Adam with coupled weight decay, AdamW, SGD with momentum,
nesterov and weight decay, RMSprop with optax's ε inside the square root)
against the optax chain ``make_optimizer`` builds, over steps with
identical gradients and a learning-rate change between them, float32 both
sides, 1e-6 relative; each scheduler's lr over epochs 0-100 within 1e-12;
unknown names refused on both sides."""

import logging

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


OPTIMIZER_CASES = [
    ("AdamW", {}),
    ("AdamW", {"weight_decay": 1e-4, "betas": [0.8, 0.99], "eps": 1e-6}),
    ("SGD", {}),
    ("SGD", {"momentum": 0.9}),
    ("SGD", {"momentum": 0.9, "nesterov": True, "weight_decay": 1e-4}),
    ("SGD", {"momentum": 0.5, "weight_decay": 0.1}),
    ("RMSprop", {}),
    ("RMSprop", {"alpha": 0.9, "eps": 1e-3}),
    ("RMSprop", {"momentum": 0.9, "eps": 1e-4}),
    # weight_decay is dropped on both sides
    ("RMSprop", {"momentum": 0.5, "weight_decay": 0.1}),
]


@pytest.mark.parametrize("name,extra", OPTIMIZER_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(OPTIMIZER_CASES)])
def test_optimizer_matches_optax(name, extra):
    rng = np.random.RandomState(1)
    p0 = rng.randn(6, 5).astype(np.float32)
    # gradients of mixed scale, so eps placement and momentum both show
    grads = [(rng.randn(6, 5) * rng.choice([1e-3, 1.0], (6, 5))).astype(
        np.float32) for _ in range(5)]
    cfg = {"lr": 1e-2, **extra}

    tx = jo.make_optimizer(name, dict(cfg))
    params = {"w": jnp.asarray(p0)}
    state = tx.init(params)
    param = torch.nn.Parameter(torch.tensor(p0))
    opt = to.make_optimizer(name, dict(cfg), [param])
    for i, g in enumerate(grads):
        if i == 3:  # an epoch boundary: both take a new learning rate
            jo.set_learning_rate(state, 3e-3)
            to.set_learning_rate(opt, 3e-3)
        updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
        param.grad = torch.tensor(g)
        opt.step()
        want = np.asarray(params["w"])
        np.testing.assert_allclose(param.detach().numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=f"step {i}")
    assert not np.array_equal(param.detach().numpy(), p0)


def test_rmsprop_puts_eps_inside_the_square_root():
    """The port's RMSprop is optax's (g / sqrt(nu + eps)), not
    ``torch.optim.RMSprop`` (g / (sqrt(nu) + eps)): with a large eps the
    two first steps differ, and the port's is the closed form."""
    g = torch.tensor([1e-2, 1.0])
    port = torch.nn.Parameter(torch.zeros(2))
    plain = torch.nn.Parameter(torch.zeros(2))
    opt = to.make_optimizer("RMSprop", {"lr": 1.0, "eps": 1e-2}, [port])
    ref = torch.optim.RMSprop([plain], lr=1.0, alpha=0.99, eps=1e-2)
    port.grad, plain.grad = g.clone(), g.clone()
    opt.step()
    ref.step()
    nu = 0.01 * g * g
    torch.testing.assert_close(port.detach(), -g / torch.sqrt(nu + 1e-2))
    assert not torch.allclose(port.detach(), plain.detach(), rtol=1e-3)


def test_rmsprop_logs_dropped_weight_decay(caplog, monkeypatch):
    monkeypatch.setattr(to, "_RMSPROP_DECAY_WARNED", False)
    with caplog.at_level(logging.WARNING):
        for _ in range(2):
            to.make_optimizer("RMSprop", {"lr": 0.1, "weight_decay": 1e-4},
                              [torch.nn.Parameter(torch.zeros(1))])
    assert caplog.text.count("ignores weight_decay") == 1


SCHEDULER_CASES = [
    ("MultiStepLR", {"milestones": [30, 60], "gamma": 0.1}),
    ("StepLR", {"step_size": 7}),
    ("StepLR", {"step_size": 30, "gamma": 0.5}),
    ("ExponentialLR", {"gamma": 0.95}),
    ("CosineAnnealingLR", {"T_max": 20, "eta_min": "1e-8"}),
    ("CosineAnnealingLR", {"T_max": 50}),
]


@pytest.mark.parametrize("name,params", SCHEDULER_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULER_CASES)])
def test_scheduler_matches_jax(name, params):
    """YAML reads ``eta_min: 1e-8`` as a string; both sides take it."""
    jsched = jo.make_scheduler(name, dict(params))
    tsched = to.make_scheduler(name, dict(params))
    for epoch in range(101):
        want = jsched.lr(epoch, 1e-5)
        assert tsched.lr(epoch, 1e-5) == pytest.approx(want, rel=1e-12,
                                                      abs=1e-20), epoch


def test_unported_names_raise():
    """Names the JAX package refuses too (``KeyError`` on both sides)."""
    with pytest.raises(KeyError):
        jo.make_optimizer("Adagrad", {"lr": 0.1})
    with pytest.raises(KeyError):
        to.make_optimizer("Adagrad", {"lr": 0.1}, [torch.nn.Parameter(
            torch.zeros(1))])
    with pytest.raises(KeyError):
        jo.make_scheduler("OneCycleLR", {"max_lr": 0.1})
    with pytest.raises(KeyError):
        to.make_scheduler("OneCycleLR", {"max_lr": 0.1})
    assert to.make_scheduler(None) is None
