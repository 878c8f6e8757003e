"""The port's UDA losses and ops against the JAX package's, on the same
seeded tensors (CPU, float32, NCHW against NHWC): ``entropy_map``,
``EntropyLoss`` (plain and with ``eta``), ``MaxSquareLoss`` and
``AdventLoss`` in value and gradient at 1e-5 relative (the same arithmetic
in another order); the FDA swap mask exactly, and
``fda_source_to_target`` within 1e-4 of the image scale (two FFT
libraries in f32), at H != W so that an axis swap cannot pass."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_uda_tpu.losses.advent import AdventLoss as JaxAdventLoss
from centernet_uda_tpu.losses.entropy import EntropyLoss as JaxEntropyLoss
from centernet_uda_tpu.losses.max_square import MaxSquareLoss as JaxMaxSquare
from centernet_uda_tpu.ops import fda as jax_fda
from centernet_uda_tpu.ops.entropy import entropy_map as jax_entropy_map
from centernet_uda_torch import losses
from centernet_uda_torch.losses.advent import AdventLoss
from centernet_uda_torch.losses.entropy import EntropyLoss
from centernet_uda_torch.losses.max_square import MaxSquareLoss
from centernet_uda_torch.ops import fda
from centernet_uda_torch.ops.entropy import entropy_map

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-7)


def logits(seed, shape=(2, 16, 24, 3), scale=3.0):
    """NHWC logits, spread enough that the softmax is far from uniform."""
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def nchw(a):
    return np.ascontiguousarray(np.moveaxis(a, -1, 1))


def nhwc(a):
    return np.moveaxis(np.asarray(a), 1, -1)


def test_entropy_map_matches_jax():
    hm = logits(0)
    want = jax_entropy_map(jnp.asarray(hm))
    got = entropy_map(torch.from_numpy(nchw(hm)))
    assert got.shape == (2, 3, 16, 24)
    np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want), **TOL)


def _loss_and_grad_pair(jax_loss, port_loss, hm):
    """(value, d/dhm) of both losses on ``hm`` (NHWC)."""
    want, jgrad = jax.value_and_grad(
        lambda h: jax_loss({"hm": h})[0])(jnp.asarray(hm))
    t = torch.from_numpy(nchw(hm)).requires_grad_(True)
    got, stats = port_loss({"hm": t})
    got.backward()
    return (float(got.detach()), nhwc(t.grad.numpy()), stats,
            float(want), np.asarray(jgrad))


@pytest.mark.parametrize("eta", [None, 1.5])
def test_entropy_loss_matches_jax(eta):
    got, grad, stats, want, jgrad = _loss_and_grad_pair(
        JaxEntropyLoss(eta=eta), EntropyLoss(eta=eta), logits(1))
    assert set(stats) == {"entropy_loss"}
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-5,
                               atol=1e-5 * np.abs(jgrad).max())


def test_max_square_loss_matches_jax():
    got, grad, stats, want, jgrad = _loss_and_grad_pair(
        JaxMaxSquare(), MaxSquareLoss(), logits(2))
    assert set(stats) == {"max_square_loss"} and got < 0
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-5,
                               atol=1e-5 * np.abs(jgrad).max())


@pytest.mark.parametrize("label", [0.0, 1.0])
def test_advent_loss_matches_jax(label):
    # logits past +-20 too, where a naive log(sigmoid) would overflow
    pred = logits(3, (2, 1, 4, 6), scale=12.0)
    want, jgrad = jax.value_and_grad(
        lambda p: JaxAdventLoss()(p, label)[0])(jnp.asarray(pred))
    t = torch.from_numpy(nchw(pred)).requires_grad_(True)
    got, stats = AdventLoss()(t, label)
    got.backward()
    assert set(stats) == {"advent_loss"}
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(nhwc(t.grad.numpy()), np.asarray(jgrad),
                               **TOL)


def test_registry_builds_the_uda_losses():
    assert isinstance(losses.build("entropy.EntropyLoss", eta=1.5),
                      EntropyLoss)
    assert isinstance(losses.build("advent.AdventLoss"), AdventLoss)
    assert isinstance(losses.build("max_square.MaxSquareLoss"),
                      MaxSquareLoss)


@pytest.mark.parametrize("h,w,beta", [(64, 96, 0.05), (64, 96, 0.1),
                                      (96, 64, 0.1), (40, 40, 0.01)])
@pytest.mark.parametrize("circular", [False, True])
def test_swap_mask_matches_jax(h, w, beta, circular):
    want = np.asarray(jax_fda._swap_mask(h, w, beta, circular))
    got = fda._swap_mask(h, w, beta, circular).numpy()
    np.testing.assert_array_equal(got, want)
    if beta >= 0.05:
        # the mask does work: some cells take each amplitude
        assert 0 < got.sum() < got.size


@pytest.mark.parametrize("beta", [0.05, 0.1])
@pytest.mark.parametrize("circular", [False, True])
def test_fda_source_to_target_matches_jax(beta, circular):
    rng = np.random.RandomState(4)
    src = rng.randn(2, 64, 96, 3).astype(np.float32)
    # another mean and contrast, so the swap moves the image
    trg = (rng.randn(2, 64, 96, 3) * 0.4 + 0.8).astype(np.float32)
    want = np.asarray(jax_fda.fda_source_to_target(
        jnp.asarray(src), jnp.asarray(trg), beta, circular))
    got = fda.fda_source_to_target(torch.from_numpy(nchw(src)),
                                   torch.from_numpy(nchw(trg)), beta,
                                   circular)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 64, 96)
    scale = np.abs(src).max()
    np.testing.assert_allclose(nhwc(got.numpy()), want, rtol=0,
                               atol=1e-4 * scale)
    assert np.abs(want - src).max() > 1e-2 * scale


def test_fda_keeps_the_source_dtype():
    src = torch.randn(1, 3, 32, 48, generator=torch.Generator().manual_seed(0))
    out = fda.fda_source_to_target(src.bfloat16(), src.flip(-1), 0.1)
    assert out.dtype == torch.bfloat16 and out.shape == src.shape
