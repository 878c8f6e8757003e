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


# the experiments' loss params (configs/experiment/coco_merged.yaml,
# keypoints.yaml)
COCO_MERGED_LOSS = dict(periodic=True, angle_weight=1.0, kp_weight=2.0,
                        kp_indices=[[0, 1], [0, 4], [1, 4], [2, 3], [1, 2],
                                    [4, 3]], kp_distance_weight=10.0)
KEYPOINTS_LOSS = dict(kp_weight=1.0, kp_indices=COCO_MERGED_LOSS["kp_indices"],
                      kp_distance_weight=0.5)


@pytest.mark.parametrize("params", [
    dict(periodic=True), dict(kp_weight=1.0), dict(kp_indices=[[0, 1]]),
    COCO_MERGED_LOSS, KEYPOINTS_LOSS,
    dict(kp_indices=[[0, 1], [2, 4]], kp_distance_weight_l1=True),
    dict(kp_indices=[[3, 1]], legacy_sqrt_bias=False, periodic=True)],
    ids=["periodic", "kp_weight", "kp_indices", "coco_merged", "keypoints",
         "l1_distance", "sqrt_bias_1e-4"])
def test_rotated_and_keypoint_variants_match_jax(params):
    """``DetectionLoss`` with the periodic angle loss (rotated ``wh`` of 3
    channels, target angles in degrees) and the keypoint loss (5
    keypoints, a per-coordinate ``kp_reg_mask``): the loss, every stat
    (``kp_loss`` among them) and d(loss)/d(outputs) against JAX's."""
    rng = np.random.RandomState(4)
    b, h, w, c, k, p = 2, 16, 16, 3, 10, 5
    periodic = params.get("periodic", False)
    with_kps = "kp_weight" in params or "kp_indices" in params
    d_wh = 3 if periodic else 2
    outputs = {"hm": rng.randn(b, h, w, c).astype(np.float32),
               "wh": (rng.randn(b, h, w, d_wh) * 3).astype(np.float32),
               "reg": rng.rand(b, h, w, 2).astype(np.float32)}
    wh = (rng.rand(b, k, d_wh) * 5).astype(np.float32)
    if periodic:
        wh[..., 2] = rng.uniform(-180, 180, (b, k))
    batch = {"hm": heatmap(rng, b, h, w, c),
             "ind": rng.randint(0, h * w, (b, k)).astype(np.int64),
             "reg_mask": (rng.rand(b, k) > 0.4).astype(np.uint8),
             "wh": wh, "reg": rng.rand(b, k, 2).astype(np.float32)}
    if with_kps:
        outputs["kps"] = (rng.randn(b, h, w, 2 * p) * 4).astype(np.float32)
        batch["kps"] = (rng.randn(b, k, 2 * p) * 4).astype(np.float32)
        batch["kp_reg_mask"] = np.repeat(rng.rand(b, k, p) > 0.3, 2,
                                         -1).astype(np.uint8)
    jloss = jl.DetectionLoss(**params)
    (want, jstats), jgrads = jax.value_and_grad(
        lambda outs: jloss(outs, batch), has_aux=True)(outputs)
    touts = {key: nchw(v).requires_grad_(True) for key, v in outputs.items()}
    tbatch = {key: (nchw(v) if key == "hm" else torch.tensor(v))
              for key, v in batch.items()}
    loss, stats = build("centernet.DetectionLoss", **params)(touts, tbatch)
    loss.backward()
    assert set(stats) == set(jstats)
    assert ("kp_loss" in stats) == with_kps
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    for key in jstats:
        np.testing.assert_allclose(float(stats[key].detach()),
                                   float(jstats[key]), **TOL, err_msg=key)
    for key in outputs:
        np.testing.assert_allclose(
            np.moveaxis(touts[key].grad.numpy(), 1, -1),
            np.asarray(jgrads[key]), **TOL, err_msg=key)


def test_sigmoid_clamped_bounds():
    x = torch.tensor([-100.0, 0.0, 100.0])
    want = np.asarray(jnp.clip(jax.nn.sigmoid(jnp.asarray(x.numpy())),
                               1e-4, 1 - 1e-4))
    got = tl.sigmoid_clamped(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
