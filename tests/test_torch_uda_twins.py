"""Twin UDA trainers for the port's parity tests: the JAX package's trainer
and the port's ``build_trainer`` on the same experiment config, from one
bridged init, as ``tests/test_torch_slice.py`` builds the baseline. The
tests here hold the discriminator's weight bridge; the trainers' tests are
in ``tests/test_torch_uda_{trainers,fda,advent}.py``.

A narrow DLA (levels 1, channels 4..32, head_conv 8), batch 2, with
``dcn_impl: xla`` on both sides, the method's UDA weight raised to 1.0 so
that the UDA term shapes the gradient, and Adam at lr 1e-4. (The first
step's gradients agree within 7e-5 of each parameter's scale, but Adam's
first step moves every element by about +-lr whatever its size, so
elements whose gradient is below the f32 noise take a random sign: at lr
1e-3 entropy minimization's ``off_loss`` parts by 3.9e-3 relative at the
third step, at 1e-4 by 3.1e-4, while the losses still move.) Each batch
has a target domain drawn with another mean and contrast than the
source.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_uda_tpu import config as jax_config
from centernet_uda_tpu import uda as jax_uda
from centernet_uda_tpu.losses.centernet import DetectionLoss as JaxLoss
from centernet_uda_tpu.models import common as jax_common
from centernet_uda_tpu.models.dla import DLASeg as JaxDLASeg
from centernet_uda_tpu.ops import dcn as jax_dcn
from centernet_uda_tpu.uda.adversarial_entropy_minimization import (
    FCDiscriminator as JaxFCDiscriminator,
)
from centernet_uda_tpu.utils import optim as jax_optim
from centernet_uda_torch.config import compose
from centernet_uda_torch.ops.gaussian import encode_targets
from centernet_uda_torch.train import build_trainer
from centernet_uda_torch.uda.adversarial_entropy_minimization import (
    FCDiscriminator,
)
from centernet_uda_torch.utils.weights import (
    disc_state_dict_from_jax,
    state_dict_from_jax,
)

torch.set_num_threads(2)

NUM_CLASSES, BATCH, MAX_DET = 3, 2, 20
LEVELS, CHANNELS, HEAD_CONV = [1, 1, 1, 1, 1, 1], [4, 8, 8, 16, 16, 32], 8
PORT_ONLY = [f"model.backend.params.levels={LEVELS}",
             f"model.backend.params.channels={CHANNELS}",
             f"model.backend.params.head_conv={HEAD_CONV}"]


def overrides(experiment, size, *extra):
    return [f"experiment={experiment}", "dcn_impl=xla",
            f"max_detections={MAX_DET}", f"batch_size={BATCH}",
            f"datasets.training.params.input_size=[{size},{size}]",
            f"model.backend.params.num_classes={NUM_CLASSES}",
            "optimizer.params.lr=0.0001", *extra]


def make_batch(seed, size):
    """A seeded detection batch (targets encoded as the data pipeline
    does) with a ``target_domain_input``."""
    rng = np.random.RandomState(seed)
    out = size // 4
    per_image = []
    for _ in range(BATCH):
        n = rng.randint(2, 6)
        xy = rng.rand(n, 2) * out * 0.7
        boxes = np.concatenate([xy, xy + rng.rand(n, 2) * out * 0.3 + 1], 1)
        per_image.append(encode_targets(boxes, rng.randint(0, NUM_CLASSES, n),
                                        out, out, NUM_CLASSES, MAX_DET))
    data = {k: np.stack([t[k] for t in per_image]) for k in per_image[0]}
    data["input"] = rng.randn(BATCH, 3, size, size).astype(np.float32)
    data["target_domain_input"] = (rng.randn(BATCH, 3, size, size) * 0.5
                                   + 0.4).astype(np.float32)
    data["id"] = np.arange(BATCH)
    return data


def to_jax(data):
    out = dict(data)
    for key in ("input", "hm", "target_domain_input"):
        if key in data:
            out[key] = np.ascontiguousarray(data[key].transpose(0, 2, 3, 1))
    return out


def jax_trainer(ovr):
    """The JAX package's trainer for the config ``ovr``, initialised."""
    jcfg = jax_config.compose(ovr)
    method = list(jcfg.model.uda.keys())[0]
    jm = jax_uda.build(method, **jcfg.model.uda[method].to_dict())
    jm.cfg = jcfg
    heads = jax_common.make_heads_dict(NUM_CLASSES, 0, False)
    jm.backend = jax_common.Backend(
        module=JaxDLASeg(heads=heads, head_conv=HEAD_CONV, levels=LEVELS,
                         channels=CHANNELS),
        down_ratio=4, rotated_boxes=False, num_classes=NUM_CLASSES,
        num_keypoints=0, heads=heads, name="dla34")
    jm.centernet_loss = JaxLoss(**jcfg.model.backend.loss.params.to_dict())
    jm.optimizer_cfg = jcfg.optimizer.to_dict()
    sched = jcfg.optimizer.scheduler
    jm.scheduler = jax_optim.make_scheduler(sched.name, sched.params)
    jm.init_done()
    return jm


def jax_variables(jm):
    return {"params": jax.tree.map(np.asarray, jm.state.params),
            "batch_stats": jax.tree.map(np.asarray, jm.state.batch_stats)}


def port_trainer(ovr, jm):
    """The port's trainer for ``ovr`` on the CPU, with ``jm``'s weights
    (and discriminator, where it has one)."""
    port = build_trainer(compose(ovr + PORT_ONLY), device="cpu")
    port.init_done()
    bridge(jm, port)
    return port


def bridge(jm, port):
    """Load ``jm``'s backend weights and statistics (and discriminator,
    where it has one) into ``port``."""
    port.backend.module.load_state_dict(state_dict_from_jax(jax_variables(jm)))
    if getattr(port, "discriminator", None) is not None:
        port.discriminator.load_state_dict(disc_state_dict_from_jax(
            jax.tree.map(np.asarray, jm.state.disc_params)))


def running_stats(jm, port):
    """{key: (port, jax)} of every BatchNorm running mean and variance, and
    the port's count of updates (of its first BatchNorm)."""
    want = state_dict_from_jax(jax_variables(jm))
    got = port.backend.module.state_dict()
    # copies: the port's buffers are updated in place by later steps
    return {"stats": {k: (got[k].numpy().copy(), want[k].numpy())
                      for k in want
                      if k.endswith(("running_mean", "running_var"))},
            "tracked": int(got["base.base_layer.1.num_batches_tracked"])}


class Twins:
    """Save and restore the JAX package's process-wide DCN and BatchNorm
    settings around the twins."""

    def __enter__(self):
        self.old = jax_dcn.get_pallas_default(), jax_common.get_bn_groups()
        jax_dcn.set_pallas_default("xla")
        jax_common.set_bn_groups(1)
        return self

    def __exit__(self, *exc):
        jax_dcn.set_pallas_default(self.old[0])
        jax_common.set_bn_groups(self.old[1])


def run_steps(jm, port, size, steps=3, after_first=None):
    """``steps`` train steps on both twins on distinct seeded batches;
    returns [(port stats, JAX stats)] as floats. ``after_first(jm, port)``
    runs after the first step and its result is returned too."""
    out, first = [], None
    for seed in range(steps):
        data = make_batch(seed, size)
        want = {k: float(v) for k, v in
                jm.step(to_jax(data), is_training=True)["stats"].items()}
        got = {k: float(v) for k, v in
               port.step(data, is_training=True)["stats"].items()}
        out.append((got, want))
        if seed == 0 and after_first is not None:
            first = after_first(jm, port)
    return out, first


def run_trainer(experiment, size, *extra, after_first=running_stats,
                before=None):
    """Both twins of ``experiment`` (``extra`` overrides): ``before(jm,
    port)`` if given, three train steps, ``after_first`` after the first (by
    default the running statistics), then an eval step on the JAX state
    after the three steps, bridged into the port."""
    ovr = overrides(experiment, size, *extra)
    with Twins():
        jm = jax_trainer(ovr)
        port = port_trainer(ovr, jm)
        init = before(jm, port) if before is not None else None
        steps, first = run_steps(jm, port, size, after_first=after_first)
        bridge(jm, port)
        data = make_batch(7, size)
        jout = jm.step(to_jax(data), is_training=False)
        pout = port.step(data, is_training=False)
    return {"steps": steps, "before": init, "first": first,
            "eval": (pout, jout), "port": port, "jax": jm, "overrides": ovr}


def check_stats(run, step, uda_stat):
    """Every stat of train step ``step`` within 1e-3 relative of JAX's;
    the total is the centernet loss plus ``uda_stat`` (weight 1.0), and it
    moved from the step before."""
    got, want = run["steps"][step]
    assert set(got) == set(want)
    assert {uda_stat, "centernet_loss", "total_loss"} <= set(got)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-3), k
    terms = (uda_stat, "dis_source", "dis_target") if uda_stat == "dis_fool" \
        else (uda_stat,)
    assert got["total_loss"] == pytest.approx(
        got["centernet_loss"] + sum(got[k] for k in terms), rel=1e-6)
    if step:
        assert got["total_loss"] != run["steps"][step - 1][0]["total_loss"]


def check_batchnorm(bn):
    """The running statistics after the first step (``running_stats``)
    within 1e-4 relative and 1e-6 absolute of JAX's ``batch_stats``
    (one-pass against two-pass f32 variance: 1.9e-5 relative seen; a run
    that drops one forward's update is off by far more), updated twice in
    that step."""
    assert len(bn["stats"]) > 10
    for key, (got, want) in bn["stats"].items():
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    assert bn["tracked"] == 2


def check_eval(run, rel=1e-4):
    """The eval step's stats and both domains' heads within ``rel`` of
    JAX's, on the same state."""
    pout, jout = run["eval"]
    assert set(pout) == {"source_domain", "target_domain", "stats"}
    assert set(pout["stats"]) == set(jout["stats"])
    for k, v in jout["stats"].items():
        assert float(pout["stats"][k]) == pytest.approx(float(v), rel=rel), k
    for dom in ("source_domain", "target_domain"):
        for head, want in jout[dom].items():
            got = pout[dom][head].numpy().transpose(0, 2, 3, 1)
            np.testing.assert_allclose(got, np.asarray(want), rtol=rel,
                                       atol=rel * np.abs(want).max(),
                                       err_msg=f"{dom}/{head}")


@pytest.mark.parametrize("hw", [(32, 32), (40, 64)])
def test_discriminator_bridge_matches_jax(hw):
    """``disc_state_dict_from_jax`` on a flax init: the port's
    ``FCDiscriminator`` gives the JAX one's output (f32 convolutions in
    another order: 1e-5 of the scale)."""
    x = np.random.RandomState(0).rand(2, *hw, 3).astype(np.float32)
    jd = JaxFCDiscriminator()
    params = jd.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(jd.apply({"params": params}, jnp.asarray(x)))
    disc = FCDiscriminator(3)
    disc.load_state_dict(disc_state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = disc(torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2)))).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (2, hw[0] // 32, hw[1] // 32, 1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_discriminator_init_is_seeded_lecun_normal():
    """The port's own init: flax's default (LeCun normal, zero bias), the
    same from the same generator seed, another from another."""
    a, b, c = (FCDiscriminator(3, generator=torch.Generator().manual_seed(s))
               for s in (43, 43, 44))
    w = a.state_dict()["2.weight"]
    assert torch.equal(w, b.state_dict()["2.weight"])
    assert not torch.equal(w, c.state_dict()["2.weight"])
    assert float(w.std()) == pytest.approx((1 / (64 * 16)) ** 0.5, rel=0.05)
    assert not any(float(v.abs().max()) for k, v in a.state_dict().items()
                   if k.endswith("bias"))
