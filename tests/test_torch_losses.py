"""The port's CenterNet losses against the JAX package's, on identical
tensors (CPU, float32): values and d(loss)/d(outputs). Same arithmetic in
another order, so 1e-5 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_uda_tpu.losses import centernet as jl
from centernet_uda_torch.losses import build
from centernet_uda_torch.losses import centernet as tl

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def heatmap(rng, b, h, w, c, with_peaks=True):
    gt = (rng.rand(b, h, w, c) ** 4).astype(np.float32)
    if with_peaks:
        for bi in range(b):
            for _ in range(3):
                gt[bi, rng.randint(h), rng.randint(w), rng.randint(c)] = 1.0
    else:
        gt = np.minimum(gt, 0.99)
    return gt


@pytest.mark.parametrize("with_peaks", [True, False])
def test_focal_loss(with_peaks):
    """Normalised by the positive count; with no positive pixel the raw
    negative sum."""
    rng = np.random.RandomState(0)
    pred = rng.uniform(0.01, 0.99, (2, 8, 8, 3)).astype(np.float32)
    gt = heatmap(rng, 2, 8, 8, 3, with_peaks)
    want, jgrad = jax.value_and_grad(jl.focal_loss)(pred, gt)
    p = nchw(pred).requires_grad_(True)
    got = tl.focal_loss(p, nchw(gt))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(np.moveaxis(p.grad.numpy(), 1, -1),
                               np.asarray(jgrad), **TOL)


@pytest.mark.parametrize("dims", [2, 3])
def test_reg_l1_loss(dims):
    """Masked L1 at ``ind``; with 3 channels the reference's angle quirk:
    prediction and target angle both sigmoided after masking."""
    rng = np.random.RandomState(1)
    out = rng.randn(2, 8, 8, dims).astype(np.float32)
    mask = (rng.rand(2, 6) > 0.3).astype(np.float32)
    ind = rng.randint(0, 64, (2, 6)).astype(np.int64)
    target = rng.randn(2, 6, dims).astype(np.float32)

    def jfn(o):
        return jl.reg_l1_loss(o, mask, ind, target, weight=0.1,
                              angle_weight=0.7)

    want, jgrad = jax.value_and_grad(jfn)(out)
    o = nchw(out).requires_grad_(True)
    got = tl.reg_l1_loss(o, torch.tensor(mask), torch.tensor(ind),
                         torch.tensor(target), weight=0.1, angle_weight=0.7)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(np.moveaxis(o.grad.numpy(), 1, -1),
                               np.asarray(jgrad), **TOL)


def test_detection_loss_values_and_grads():
    rng = np.random.RandomState(2)
    b, h, w, c, k = 2, 16, 16, 3, 10
    outputs = {"hm": rng.randn(b, h, w, c).astype(np.float32),
               "wh": (rng.rand(b, h, w, 2) * 5).astype(np.float32),
               "reg": rng.rand(b, h, w, 2).astype(np.float32)}
    batch = {"hm": heatmap(rng, b, h, w, c),
             "ind": rng.randint(0, h * w, (b, k)).astype(np.int64),
             "reg_mask": (rng.rand(b, k) > 0.4).astype(np.uint8),
             "wh": (rng.rand(b, k, 2) * 5).astype(np.float32),
             "reg": rng.rand(b, k, 2).astype(np.float32)}
    params = dict(hm_weight=1.0, wh_weight=0.1, off_weight=1.0)
    jloss = jl.DetectionLoss(**params)

    def jfn(outs):
        return jloss(outs, batch)

    (want, jstats), jgrads = jax.value_and_grad(jfn, has_aux=True)(outputs)
    touts = {key: nchw(v).requires_grad_(True) for key, v in outputs.items()}
    tbatch = {key: (nchw(v) if key == "hm" else torch.tensor(v))
              for key, v in batch.items()}
    loss, stats = build("centernet.DetectionLoss", **params)(touts, tbatch)
    loss.backward()
    assert set(stats) == set(jstats)
    for key in jstats:
        np.testing.assert_allclose(float(stats[key].detach()),
                                   float(jstats[key]), **TOL, err_msg=key)
    for key in outputs:
        np.testing.assert_allclose(
            np.moveaxis(touts[key].grad.numpy(), 1, -1),
            np.asarray(jgrads[key]), **TOL, err_msg=key)


@pytest.mark.parametrize("params", [dict(periodic=True), dict(kp_weight=1.0),
                                    dict(kp_indices=[[0, 1]])])
def test_unported_variants_raise(params):
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        tl.DetectionLoss(**params)


def test_sigmoid_clamped_bounds():
    x = torch.tensor([-100.0, 0.0, 100.0])
    want = np.asarray(jnp.clip(jax.nn.sigmoid(jnp.asarray(x.numpy())),
                               1e-4, 1 - 1e-4))
    got = tl.sigmoid_clamped(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
