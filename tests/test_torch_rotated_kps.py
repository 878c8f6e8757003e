"""Rotated boxes and keypoints in the port against the JAX package (CPU,
float32): the periodic angle loss, the keypoint loss, rotated and keypoint
decode, ``get_detections``, and three train steps of a narrow DLA-34 with
rotated and keypoint heads under ``coco_merged``'s loss params.

The periodic loss takes its angles on both sides of +-pi/2 and +-pi, where
``torch.fmod`` (the dividend's sign) and ``jnp.mod`` (the divisor's) part:
the test shows that an ``fmod`` port would fail. Decode runs on heatmaps
with distinct scores, since top-k ties are ordered differently by the two
frameworks. Losses and decode are the same f32 arithmetic in another order
(1e-5 relative); the trajectory is held at 1e-3 after three Adam steps at
lr 1e-4 (``tests/test_torch_uda_twins.py`` says why).

The trajectory runs at 96 px, where the narrow DLA's deepest maps are 3 x 3.
At 64 px they are 2 x 2 (8 values a channel at batch 2), and flax's
one-pass BatchNorm variance (ROADMAP Queue C) puts f32 noise into JAX's
gradients there: against the port run in float64 on the same weights and
batch, JAX's first-step gradient of ``dla_up.ida_2.proj_2.actf.0.bias`` is
off by 10.7 % of its scale and the port's f32 one by 6.2e-6; every port
f32 gradient is within 1.1e-5 of scale. At 96 px JAX's are within 3.3e-5,
the port's within 1.8e-5 (measured for this file on the CPU).
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_uda_tpu import config as jax_config
from centernet_uda_tpu.losses import centernet as jl
from centernet_uda_tpu.models import common as jax_common
from centernet_uda_tpu.models.dla import DLASeg as JaxDLASeg
from centernet_uda_tpu.ops import dcn as jax_dcn
from centernet_uda_tpu.ops import decode as jd
from centernet_uda_tpu.uda.base import Model as JaxModel
from centernet_uda_torch.config import compose
from centernet_uda_torch.losses import centernet as tl
from centernet_uda_torch.ops import decode as td
from centernet_uda_torch.ops.gaussian import encode_targets
from centernet_uda_torch.train import build_trainer
from centernet_uda_torch.uda.base import Model
from centernet_uda_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
NUM_CLASSES, NUM_KPS, SIZE, BATCH, MAX_DET = 3, 5, 64, 2, 20
KP_INDICES = [[0, 1], [0, 4], [1, 4], [2, 3], [1, 2], [4, 3]]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


# --- periodic angle loss ---------------------------------------------------

# angle differences pred - target (radians) on both sides of -pi, -pi/2, 0,
# pi/2 and pi
DIFFS = [-math.pi - 0.2, -math.pi + 0.2, -math.pi / 2 - 0.1,
         -math.pi / 2 + 0.1, -0.3, 0.3, math.pi / 2 - 0.1,
         math.pi / 2 + 0.1, math.pi - 0.2, math.pi + 0.2]


def periodic_inputs():
    rng = np.random.RandomState(5)
    b, h, w, k = 2, 8, 8, len(DIFFS)
    pred_angle = rng.uniform(-2.5, 2.5, (b, k))
    target_deg = np.degrees(pred_angle - np.array(DIFFS)[None])
    ind = np.stack([rng.permutation(h * w)[:k] for _ in range(b)])
    out = (rng.randn(b, h, w, 3) * 2).astype(np.float32)
    raw = np.log((pred_angle + np.pi) / (np.pi - pred_angle))  # logit
    for bi in range(b):
        out[bi].reshape(-1, 3)[ind[bi], 2] = raw[bi]
    target = np.concatenate([rng.rand(b, k, 2) * 5, target_deg[..., None]],
                            -1).astype(np.float32)
    mask = np.ones((b, k), np.float32)
    mask[0, -1] = 0
    return out, mask, ind.astype(np.int64), target


def test_periodic_loss_matches_jax_across_the_wraps():
    out, mask, ind, target = periodic_inputs()

    def jfn(o):
        return jl.periodic_reg_l1_loss(o, mask, ind, target, 0.1, 0.7)

    want, jgrad = jax.value_and_grad(jfn)(out)
    o = nchw(out).requires_grad_(True)
    got = tl.periodic_reg_l1_loss(o, torch.tensor(mask), torch.tensor(ind),
                                  torch.tensor(target), 0.1, 0.7)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(nhwc(o.grad), np.asarray(jgrad), **TOL)

    # the angle term alone, per object: an fmod port parts from jnp.mod
    pred = tl.gather_features_nchw(nchw(out), torch.tensor(ind))
    pa = tl.sigmoid_clamped(pred[..., 2]) * 2 * math.pi - math.pi
    d = pa - torch.deg2rad(torch.tensor(target[..., 2])) - math.pi / 2
    want_terms = np.abs(np.mod(d.numpy(), np.pi) - np.pi / 2)
    port_terms = (torch.remainder(d, math.pi) - math.pi / 2).abs().numpy()
    fmod_terms = (torch.fmod(d, math.pi) - math.pi / 2).abs().numpy()
    np.testing.assert_allclose(port_terms, want_terms, rtol=1e-5, atol=1e-5)
    assert (np.abs(fmod_terms - want_terms) > 0.1).sum() >= 10


# --- keypoint loss -----------------------------------------------------------


@pytest.mark.parametrize("kp_indices,l1,legacy", [
    (None, False, True),
    (KP_INDICES, False, True),
    (KP_INDICES, False, False),
    (KP_INDICES, True, True),
    ([[3, 1]], False, False),
], ids=["no_pairs", "l2_bias_1e4", "l2_bias_1e-4", "l1", "one_pair"])
def test_kps_loss_matches_jax(kp_indices, l1, legacy):
    rng = np.random.RandomState(6)
    b, h, w, k = 2, 8, 8, 6
    out = (rng.randn(b, h, w, 2 * NUM_KPS) * 4).astype(np.float32)
    ind = rng.randint(0, h * w, (b, k)).astype(np.int64)
    target = (rng.randn(b, k, 2 * NUM_KPS) * 4).astype(np.float32)
    mask = np.repeat(rng.rand(b, k, NUM_KPS) > 0.3, 2, -1).astype(np.uint8)
    kw = dict(weight=1.5, kp_indices=kp_indices, distance_weight=0.5,
              use_l1_distance=l1, legacy_sqrt_bias=legacy)

    want, jgrad = jax.value_and_grad(
        lambda o: jl.kps_l1_loss(o, mask, ind, target, **kw))(out)
    o = nchw(out).requires_grad_(True)
    got = tl.kps_l1_loss(o, torch.tensor(mask), torch.tensor(ind),
                         torch.tensor(target), **kw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(nhwc(o.grad), np.asarray(jgrad), **TOL)


# --- decode ------------------------------------------------------------------


def distinct_heatmap(rng, b, h, w, c):
    """Logits whose sigmoids are all distinct (no top-k ties)."""
    vals = rng.permutation(b * h * w * c).astype(np.float32)
    return ((vals / vals.max()) * 8 - 4).reshape(b, h, w, c)


@pytest.mark.parametrize("rotated,with_kps", [(True, False), (False, True),
                                              (True, True)])
def test_decode_matches_jax(rotated, with_kps):
    rng = np.random.RandomState(7)
    b, h, w, c, k = 2, 16, 16, NUM_CLASSES, 20
    hm = distinct_heatmap(rng, b, h, w, c)
    wh = (rng.randn(b, h, w, 3 if rotated else 2) * 4).astype(np.float32)
    reg = rng.rand(b, h, w, 2).astype(np.float32)
    kps = ((rng.randn(b, h, w, 2 * NUM_KPS) * 5).astype(np.float32)
           if with_kps else None)
    want = jd.decode_detections(
        jnp.asarray(hm), jnp.asarray(wh), jnp.asarray(reg),
        kps=None if kps is None else jnp.asarray(kps), k=k, rotated=rotated,
        apply_sigmoid=True)
    got = td.decode_detections(nchw(hm), nchw(wh), nchw(reg),
                               kps=None if kps is None else nchw(kps), k=k,
                               rotated=rotated, apply_sigmoid=True)
    if with_kps:
        (want, want_kps), (got, got_kps) = want, got
        assert got_kps.shape == (b, k, NUM_KPS, 2)
        np.testing.assert_allclose(got_kps.numpy(), np.asarray(want_kps),
                                   **TOL)
    assert got.shape == (b, k, 7 if rotated else 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --- get_detections and a trajectory -----------------------------------------


def make_batch(seed, rotated=True, num_kps=NUM_KPS, size=SIZE):
    """A seeded batch with rotated boxes (``wh`` = w, h, angle in degrees;
    ``gt_dets`` = cx, cy, w, h, angle, 1, class) and keypoints (offsets
    from the center, a per-coordinate mask, ``gt_kps`` in map pixels)."""
    rng = np.random.RandomState(seed)
    out = size // 4
    per_image = []
    for _ in range(BATCH):
        n = rng.randint(2, 6)
        xy = rng.rand(n, 2) * out * 0.7
        boxes = np.concatenate([xy, xy + rng.rand(n, 2) * out * 0.3 + 1], 1)
        t = encode_targets(boxes, rng.randint(0, NUM_CLASSES, n), out, out,
                           NUM_CLASSES, MAX_DET)
        valid = t["reg_mask"][:, None].astype(np.float32)
        if rotated:
            angle = rng.uniform(-90, 90, (MAX_DET, 1)).astype(np.float32)
            t["wh"] = np.concatenate([t["wh"], angle * valid], 1)
            d = t["gt_dets"]
            ctr = (d[:, 0:2] + d[:, 2:4]) / 2
            t["gt_dets"] = np.concatenate(
                [ctr, d[:, 2:4] - d[:, 0:2], angle, d[:, 4:6]], 1) * valid
        if num_kps:
            t["kps"] = (rng.randn(MAX_DET, 2 * num_kps) * 3).astype(
                np.float32) * valid
            vis = (rng.rand(MAX_DET, num_kps) > 0.2) & (valid > 0)
            t["kp_reg_mask"] = np.repeat(vis, 2, -1).astype(np.uint8)
            t["gt_kps"] = (rng.rand(MAX_DET, num_kps, 2) * out).astype(
                np.float32)
        per_image.append(t)
    data = {k: np.stack([t[k] for t in per_image]) for k in per_image[0]}
    data["input"] = rng.randn(BATCH, 3, size, size).astype(np.float32)
    data["id"] = np.arange(BATCH)
    return data


def to_jax(data):
    out = dict(data)
    out["input"] = np.ascontiguousarray(data["input"].transpose(0, 2, 3, 1))
    out["hm"] = np.ascontiguousarray(data["hm"].transpose(0, 2, 3, 1))
    return out


@pytest.mark.parametrize("rotated,num_kps", [(True, NUM_KPS), (True, 0),
                                             (False, NUM_KPS)])
def test_get_detections_matches_jax(rotated, num_kps):
    """The same heads and batch through both trainers' ``get_detections``:
    rotated rows keep the box in 0-4 and score and class in 5 and 6; the
    keypoints come scaled by ``down_ratio``."""
    rng = np.random.RandomState(8)
    h = SIZE // 4
    heads = {"hm": distinct_heatmap(rng, BATCH, h, h, NUM_CLASSES),
             "wh": (rng.randn(BATCH, h, h, 3 if rotated else 2) * 4
                    ).astype(np.float32),
             "reg": rng.rand(BATCH, h, h, 2).astype(np.float32)}
    if num_kps:
        heads["kps"] = (rng.randn(BATCH, h, h, 2 * num_kps) * 3).astype(
            np.float32)
    data = make_batch(9, rotated, num_kps)
    backend = SimpleNamespace(down_ratio=4, rotated_boxes=rotated)
    cfg = {"max_detections": MAX_DET}

    jm = JaxModel()
    jm.cfg, jm.backend = cfg, backend
    jm._decode = jax.jit(jm._make_decode())
    want = jm.get_detections(
        {"source_domain": {k: jnp.asarray(v) for k, v in heads.items()}},
        to_jax(data))
    port = Model(device="cpu")
    port.cfg, port.backend = cfg, backend
    got = port.get_detections(
        {"source_domain": {k: nchw(v) for k, v in heads.items()}}, data)

    assert set(got) == set(want)
    assert ("pred_kps" in got) == bool(num_kps)
    assert got["pred_boxes"].shape == (BATCH, MAX_DET, 5 if rotated else 4)
    for key in ("pred_boxes", "pred_scores", "pred_kps"):
        if key in want:
            np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                       **TOL, err_msg=key)
    np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
    for key in ("gt_boxes", "gt_classes", "gt_ids", "gt_areas", "gt_kps"):
        for g, w in zip(got.get(key, []), want.get(key, [])):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=key)


LEVELS, CHANNELS, HEAD_CONV = [1, 1, 1, 1, 1, 1], [4, 8, 8, 16, 16, 32], 8
TRAJ_SIZE = 96
LOSS_OVERRIDES = [
    "model.backend.loss.params.periodic=true",
    "model.backend.loss.params.kp_weight=2.0",
    f"model.backend.loss.params.kp_indices={KP_INDICES}",
    "model.backend.loss.params.kp_distance_weight=10.0"]
OVERRIDES = [
    "experiment=baseline", "dcn_impl=xla", f"max_detections={MAX_DET}",
    f"batch_size={BATCH}",
    f"datasets.training.params.input_size=[{TRAJ_SIZE},{TRAJ_SIZE}]",
    f"model.backend.params.num_classes={NUM_CLASSES}",
    "model.backend.params.rotated_boxes=true",
    f"model.backend.params.num_keypoints={NUM_KPS}",
    "optimizer.params.lr=0.0001", *LOSS_OVERRIDES]
PORT_ONLY = [f"model.backend.params.levels={LEVELS}",
             f"model.backend.params.channels={CHANNELS}",
             f"model.backend.params.head_conv={HEAD_CONV}"]
LOSSES = ("hm_loss", "wh_loss", "off_loss", "kp_loss", "total_loss")


def jax_state(jm):
    return {"params": jax.tree.map(np.asarray, jm.state.params),
            "batch_stats": jax.tree.map(np.asarray, jm.state.batch_stats)}


@pytest.fixture(scope="module")
def trainers():
    old = jax_dcn.get_pallas_default(), jax_common.get_bn_groups()
    jax_dcn.set_pallas_default("xla")
    jax_common.set_bn_groups(1)
    jcfg = jax_config.compose(OVERRIDES)
    heads = jax_common.make_heads_dict(NUM_CLASSES, NUM_KPS, True)
    jm = JaxModel()
    jm.cfg = jcfg
    jm.backend = jax_common.Backend(
        module=JaxDLASeg(heads=heads, head_conv=HEAD_CONV, levels=LEVELS,
                         channels=CHANNELS),
        down_ratio=4, rotated_boxes=True, num_classes=NUM_CLASSES,
        num_keypoints=NUM_KPS, heads=heads, name="dla34")
    jm.centernet_loss = jl.DetectionLoss(
        **jcfg.model.backend.loss.params.to_dict())
    jm.optimizer_cfg = jcfg.optimizer.to_dict()
    jm.init_done()

    port = build_trainer(compose(OVERRIDES + PORT_ONLY), device="cpu")
    port.init_done()
    port.backend.module.load_state_dict(state_dict_from_jax(jax_state(jm)))
    steps = []
    for seed in range(3):
        data = make_batch(seed, size=TRAJ_SIZE)
        want = {k: float(v) for k, v in
                jm.step(to_jax(data), is_training=True)["stats"].items()}
        got = {k: float(v) for k, v in
               port.step(data, is_training=True)["stats"].items()}
        steps.append((got, want))
    yield jm, port, steps
    jax_dcn.set_pallas_default(old[0])
    jax_common.set_bn_groups(old[1])


@pytest.mark.parametrize("step", [0, 1, 2])
def test_rotated_kps_trajectory_matches_jax(trainers, step):
    got, want = trainers[2][step]
    assert set(got) == set(want)
    for k in LOSSES:
        assert got[k] == pytest.approx(want[k], rel=1e-3), k
    if step:
        assert got["total_loss"] != trainers[2][step - 1][0]["total_loss"]


def test_rotated_kps_eval_and_detections_match_jax(trainers):
    """Eval step and ``get_detections`` on the JAX weights after the three
    steps, bridged into the port (as ``tests/test_torch_slice.py``)."""
    jm, port, _ = trainers
    port.backend.module.load_state_dict(state_dict_from_jax(jax_state(jm)))
    data = make_batch(7, size=TRAJ_SIZE)
    jout = jm.step(to_jax(data), is_training=False)
    pout = port.step(data, is_training=False)
    for k in LOSSES:
        assert float(pout["stats"][k]) == pytest.approx(
            float(jout["stats"][k]), rel=1e-3), k
    want = jm.get_detections(jout, to_jax(data))
    got = port.get_detections(pout, data)
    assert got["pred_boxes"].shape == (BATCH, MAX_DET, 5)
    assert got["pred_kps"].shape == (BATCH, MAX_DET, NUM_KPS, 2)
    scores = np.asarray(want["pred_scores"])
    # distinct scores: the top-k order is defined on both sides
    assert all(len(np.unique(row)) == MAX_DET for row in scores)
    np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
    np.testing.assert_allclose(got["pred_scores"], scores, rtol=1e-3,
                               atol=1e-6)
    # boxes (cx, cy, w, h in input pixels, the angle in degrees) and
    # keypoints in input pixels; sub-pixel f32 noise
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"],
                               atol=1e-2)
    np.testing.assert_allclose(got["pred_kps"], want["pred_kps"], atol=1e-2)
    for key in ("gt_boxes", "gt_classes", "gt_ids", "gt_areas", "gt_kps"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a, b, err_msg=key)
