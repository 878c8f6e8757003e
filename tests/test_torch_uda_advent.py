"""The port's ADVENT trainer against the JAX package's, from one bridged
init of the backend and the discriminator (``tests/test_torch_uda_twins.py``): a
narrow DLA at 128 px (the discriminator's five stride-2 convs need a
32 x 32 heatmap), batch 2, ``dcn_impl: xla`` on both sides,
``adversarial_weight`` 1.0 and the discriminator's default Adam at lr
1e-3.

Per step, over three steps, every stat (``dis_source``, ``dis_target``,
``dis_fool``, ``total_loss`` and the CenterNet terms) within 1e-3 relative:
both updates come from the same pre-update state, and the discriminator
gets no gradient from the fool loss, or the stats would part after the
first step. After one step, the BatchNorm statistics as in
``tests/test_torch_uda_trainers.py``, and the discriminator's output on a
fixed input within 1e-4 of its scale (measured: 4.6e-6; the step moves
that output by 0.65, and a gradient of the wrong loss would move it
elsewhere). Then the eval step within
1e-4. Besides: the refusals, the registry, the discriminator's schedule
and its checkpoint round trip."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_uda_torch import uda
from centernet_uda_torch.config import compose
from centernet_uda_torch.train import build_trainer
from centernet_uda_torch.uda.adversarial_entropy_minimization import (
    AdversarialEntropyMinimization,
    FCDiscriminator,
)
from tests import test_torch_uda_twins as tw

torch.set_num_threads(2)

SIZE = 128
WEIGHT = "model.uda.AdversarialEntropyMinimization.adversarial_weight=1.0"


def disc_input():
    """A fixed entropy-map-like input: (2, 3, 32, 32) in [0, 0.55)."""
    return (np.random.RandomState(11).rand(2, 3, 32, 32) * 0.55).astype(
        np.float32)


def disc_outputs(jm, port):
    x = disc_input()
    want = jm.discriminator.apply({"params": jm.state.disc_params},
                                  jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        got = port.discriminator(torch.from_numpy(x))
    return got.numpy().transpose(0, 2, 3, 1), np.asarray(want)


@pytest.fixture(scope="module")
def run():
    def after_first(jm, port):
        return {"bn": tw.running_stats(jm, port),
                "disc": disc_outputs(jm, port)}

    out = tw.run_trainer("adversarial_entropy_minimization", SIZE, WEIGHT,
                         after_first=after_first, before=disc_outputs)
    assert type(out["port"]) is AdversarialEntropyMinimization
    return out


@pytest.mark.parametrize("step", [0, 1, 2])
def test_stats_match_jax(run, step):
    got, _ = run["steps"][step]
    assert {"dis_source", "dis_target", "dis_fool"} <= set(got)
    tw.check_stats(run, step, "dis_fool")


def test_batchnorm_statistics_match_jax_after_one_step(run):
    tw.check_batchnorm(run["first"]["bn"])


def test_discriminator_matches_jax_after_one_step(run):
    got, want = run["first"]["disc"]
    assert got.shape == want.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    # the step moved it (the same init on both sides before)
    before, want_before = run["before"]
    np.testing.assert_allclose(before, want_before, rtol=1e-5, atol=1e-6)
    assert np.abs(got - before).max() > 1e-2 * np.abs(want).max()


def test_eval_step_matches_jax(run):
    tw.check_eval(run)


def test_checkpoint_round_trips_the_discriminator(run, tmp_path):
    """``save_model`` writes ``discriminator.ckpt`` next to the model; a
    resume into a trainer from another seed restores D, its optimizer and
    the epoch; a plain load restores D's weights only."""
    port = run["port"]
    path = tmp_path / "model_last.ckpt"
    port.save_model(path, 4, with_optimizer=True)
    assert (tmp_path / "discriminator.ckpt").is_file()

    def fresh():
        t = build_trainer(compose(run["overrides"] + tw.PORT_ONLY
                                  + ["seed=5"]), device="cpu")
        t.init_done()
        return t

    other = fresh()
    before = other.discriminator.state_dict()["0.weight"].clone()
    assert other.load_model(path, resume=True) == 5
    for key, want in port.discriminator.state_dict().items():
        torch.testing.assert_close(other.discriminator.state_dict()[key],
                                   want, rtol=0, atol=0)
    assert not torch.equal(before, other.discriminator.state_dict()[
        "0.weight"])
    got, want = (o.disc_optimizer.state_dict() for o in (other, port))
    assert set(got["state"]) == set(want["state"]) and want["state"]
    for idx, state in want["state"].items():
        for key, value in state.items():
            torch.testing.assert_close(got["state"][idx][key], value,
                                       rtol=0, atol=0)
    assert other.optimizer.state_dict()["state"]

    plain = fresh()
    assert plain.load_model(path) == 1
    torch.testing.assert_close(plain.discriminator.state_dict()["8.bias"],
                               port.discriminator.state_dict()["8.bias"],
                               rtol=0, atol=0)
    assert not plain.disc_optimizer.state_dict()["state"]


def test_discriminator_optimizer_and_schedule_follow_the_config():
    cfg = compose(tw.overrides(
        "adversarial_entropy_minimization", SIZE,
        "model.uda.AdversarialEntropyMinimization.optimizer={name: Adam, "
        "params: {lr: 0.002, weight_decay: 0.0001}, scheduler: {name: "
        "MultiStepLR, params: {milestones: [2], gamma: 0.1}}}")
        + tw.PORT_ONLY)
    trainer = build_trainer(cfg, device="cpu")
    trainer.init_done()
    group = trainer.disc_optimizer.param_groups[0]
    assert (group["lr"], group["weight_decay"]) == (0.002, 0.0001)
    trainer.epoch_end()
    assert group["lr"] == pytest.approx(0.002)
    trainer.epoch_end()
    assert group["lr"] == pytest.approx(0.0002)
    # the backend's own schedule (MultiStepLR [30, 60]) has not moved
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)


@pytest.mark.parametrize("experiment,size", [
    ("entropy_minimization", 64), ("max_squares_minimization", 64),
    ("fda", 64), ("adversarial_entropy_minimization", SIZE)])
@pytest.mark.parametrize("is_training", [True, False])
def test_uda_step_without_target_domain_raises(experiment, size,
                                               is_training):
    trainer = build_trainer(compose(tw.overrides(experiment, size)
                                    + tw.PORT_ONLY), device="cpu")
    trainer.init_done()
    data = tw.make_batch(0, size)
    del data["target_domain_input"]
    with pytest.raises(ValueError, match="target domain"):
        trainer.step(data, is_training=is_training)


@pytest.mark.parametrize("shape", [(31, 32), (32, 31), (16, 16)])
def test_discriminator_refuses_maps_below_32(shape):
    disc = FCDiscriminator(3)
    with pytest.raises(ValueError, match="too small"):
        disc(torch.zeros(1, 3, *shape))
    assert disc(torch.zeros(1, 3, 32, 32)).shape == (1, 1, 1, 1)


@pytest.mark.parametrize("name", [
    "EntropyMinimization", "entropy_minimization.EntropyMinimization",
    "MaxSquaresMinimization",
    "max_squares_minimization.MaxSquaresMinimization", "FDA", "fda.FDA",
    "AdversarialEntropyMinimization",
    "adversarial_entropy_minimization.AdversarialEntropyMinimization"])
def test_registry_resolves_bare_and_dotted_names(name):
    params = {"EntropyMinimization": {"entropy_weight": 0.1},
              "MaxSquaresMinimization": {"max_squares_weight": 0.1},
              "FDA": {"entropy_weight": 0.1, "beta": 0.1},
              "AdversarialEntropyMinimization": {"adversarial_weight": 0.1}}
    cls_name = name.split(".")[-1]
    trainer = uda.build(name, device="cpu", **params[cls_name])
    assert type(trainer).__name__ == cls_name
    assert trainer.requires_target_domain and trainer.device.type == "cpu"
    with pytest.raises(KeyError, match="unknown UDA method"):
        uda.build("Nope")
