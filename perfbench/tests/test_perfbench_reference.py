"""The frozen reference against the port's CPU path at 64 px: the state
dict's names and shapes, the forward, the losses, one Adam step, decode.

On the CPU the port's DCN layers run their plain twin
(``dcn_impl=cuda``), which has the kernels' arithmetic: x, the weight and
the samples rounded to bfloat16. At one image every op of the two sides
meets the same float32 order, so they agree to float32 rounding; the
tolerances are a few ulps of float32 scaled up by the layers' depth.
"""

import math

import pytest
import torch

from perfbench import gen, harness
from perfbench import weights as weights_lib
from perfbench.check import make_net
from perfbench.reference import train as rtrain

REF = harness.load_json(harness.HERE / "configs"
                        / "dla34_baseline.json")["reference"]
LOSS = REF["loss"]
SEED = 2 ** 33 + 11


@pytest.fixture(scope="module")
def pair():
    from centernet_uda_torch import models

    net = make_net(REF)
    w = weights_lib.make(net.spec(), SEED, "cpu")
    weights_lib.calibrate(net, w, gen.images(SEED, 3, 2, 64, "cpu"))
    backend = models.build("dla", num_classes=6, dcn_impl="cuda",
                           device="cpu")
    backend.module.load_state_dict(w)
    return net, w, backend.module


def test_spec_is_the_port_state_dict(pair):
    net, _, module = pair
    sd = module.state_dict()
    assert [n for n, _, _ in net.spec()] and {
        n: tuple(s) for n, s, _ in net.spec()} == {
        n: tuple(t.shape) for n, t in sd.items()}


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_forward(pair, mode):
    net, w, module = pair
    x = gen.images(SEED, 1, 1, 64, "cpu")
    module.load_state_dict(w)  # a train-mode forward moves the statistics
    module.train(mode == "train")
    with torch.no_grad():
        got = module(x)
        want = net.forward(w, x, mode)
    for k in want:
        scale = float(want[k].abs().max())
        assert float((got[k] - want[k]).abs().max()) <= 1e-5 * scale, k


def test_losses_and_entropy(pair):
    from centernet_uda_torch.losses.centernet import DetectionLoss
    from centernet_uda_torch.losses.entropy import EntropyLoss

    net, w, _ = pair
    batch = gen.batches({"input_size": 64, "batch": 2, "cycle": 1,
                         "objects": [2, 5], "box_px": [8, 32]}, SEED, 2,
                        REF["heads"], 150, False, "cpu")[0]
    batch = {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}
    with torch.no_grad():
        heads = net.forward(w, batch["input"], "train")
    got_total, got = DetectionLoss(**LOSS)(heads, batch)
    want_total, want = rtrain.detection_loss(heads, batch, LOSS)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6)
    assert float(got_total) == pytest.approx(float(want_total), rel=1e-6)
    e_got, _ = EntropyLoss()(heads, batch)
    assert float(e_got) == pytest.approx(
        float(rtrain.entropy_loss(heads["hm"])), rel=1e-6)


def test_one_adam_step():
    g = torch.Generator().manual_seed(3)
    params = [torch.randn(5, 7, generator=g), torch.randn(3, generator=g)]
    grads = [torch.randn_like(p) for p in params]
    theirs = [p.clone().requires_grad_(True) for p in params]
    opt = torch.optim.Adam(theirs, lr=5e-5, weight_decay=1e-4)
    for t, gr in zip(theirs, grads):
        t.grad = gr.clone()
    opt.step()
    ours = [p.clone() for p in params]
    fed = rtrain.Adam(ours, 5e-5, 1e-4).step(grads)
    for a, b, p, gr, f in zip(theirs, ours, params, grads, fed):
        assert torch.allclose(a.detach(), b, rtol=0, atol=1e-9)
        assert torch.allclose(f, gr + 1e-4 * p)


def test_decode(pair):
    from centernet_uda_torch.ops.decode import decode_detections

    net, w, _ = pair
    w = dict(w)
    for n in w:
        if n.endswith(("running_mean", "running_var")):
            w[n] = w[n].clone()
    weights_lib.calibrate(net, w, gen.images(SEED, 3, 2, 128, "cpu"))
    x = gen.images(SEED, 1, 2, 128, "cpu")
    with torch.no_grad():
        heads = net.forward(w, x, "eval")
    dets = decode_detections(heads["hm"], heads["wh"], heads["reg"], k=150,
                             apply_sigmoid=True)
    top = rtrain.top_detections(heads, 150, 4)
    assert torch.allclose(dets[..., 4], top["scores"], rtol=0, atol=1e-7)
    assert torch.equal(dets[..., 5].long(), top["classes"])
    assert torch.allclose(dets[..., :4] * 4, top["boxes"], rtol=1e-6,
                          atol=1e-4)
    assert not math.isnan(float(top["boxes"].sum()))


def _bumps(tops):
    """Heads of one class on a 32 x 32 map: a logit plateau of 3 x 3
    cells at each ``(y, x, score)``, the centre at ``score`` and its ring a
    little lower, a low background; size 8 x 8 cells, offsets 0.5."""
    logit = torch.full((1, 1, 32, 32), -6.0)
    for y, x, score in tops:
        z = math.log(score / (1 - score))
        logit[..., y - 1:y + 2, x - 1:x + 2] = z - 0.02
        logit[..., y, x] = z
    return {"hm": logit, "wh": torch.full((1, 2, 32, 32), 8.0),
            "reg": torch.full((1, 2, 32, 32), 0.5)}


def test_peak_cover_judges_the_selection():
    from perfbench import check

    heads = _bumps([(5, 5, 0.9), (20, 20, 0.7), (10, 26, 0.5),
                    (27, 8, 0.3)])
    k = 3
    same = rtrain.top_detections(heads, k, 4)
    assert check.detection_numbers(same, heads, k, 4)["peak_cover"] <= 0
    # the 0.9 top's maximum moved to the edge of its plateau: covered
    moved = {key: v.clone() for key, v in same.items()}
    pos = torch.tensor([[5 * 32 + 6, 20 * 32 + 20, 10 * 32 + 26]])
    moved["boxes"] = rtrain.boxes_at(heads, pos, 4)
    assert check.detection_numbers(moved, heads, k, 4)["peak_cover"] < 0.01
    # no suppression: the 0.9 plateau fills all three, the 0.7 and 0.5
    # peaks are not covered (0.7 beats the 3rd peak, 0.5, by 0.2)
    flat = check.unsuppressed(heads, k, 4)
    assert check.detection_numbers(flat, heads, k, 4)["peak_cover"] == \
        pytest.approx(0.2, abs=1e-6)


def test_a_nets_own_kinds():
    """A net's own kinds fill from their slice of the one draw, in the
    spec's order; the harness's kinds cannot be redefined."""
    spec = [("a", (2, 3), "conv"), ("b", (4,), "twice"), ("c", (2,), "zero")]
    kinds = {"twice": lambda shape, z: 2 * z}
    got = weights_lib.make(spec, SEED, "cpu", kinds=kinds)
    drawn = weights_lib.make([("a", (2, 3), "conv"), ("b", (4,), "bn_bias")],
                             SEED, "cpu")
    assert torch.equal(got["a"], drawn["a"])
    assert torch.allclose(got["b"], 20 * drawn["b"])
    assert torch.equal(got["c"], torch.zeros(2))
    with pytest.raises(ValueError, match="conv"):
        weights_lib.make(spec, SEED, "cpu", kinds={"conv": kinds["twice"]})


ROTATED = harness.load_json(harness.HERE / "tests"
                            / "dla34_rotated_kps.json")["reference"]


@pytest.fixture(scope="module")
def rotated_heads():
    """Train-mode heads of the rotated, keypoint configuration's net at
    64 px, and a batch of its targets."""
    net = make_net(ROTATED)
    w = weights_lib.make(net.spec(), SEED, "cpu", kinds=net.kinds)
    batch = gen.batches({"input_size": 64, "batch": 2, "cycle": 1,
                         "objects": [2, 5], "box_px": [8, 32]}, SEED, 2,
                        ROTATED["heads"], 150, False, "cpu")[0]
    batch = {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}
    with torch.no_grad():
        heads = net.forward(w, batch["input"], "train")
    return heads, batch


@pytest.mark.parametrize("change", [{}, {"periodic": False},
                                    {"kp_distance_weight_l1": True},
                                    {"kp_indices": None}])
def test_rotated_and_keypoint_losses(rotated_heads, change):
    from centernet_uda_torch.losses.centernet import DetectionLoss

    heads, batch = rotated_heads
    loss = {**ROTATED["loss"], **change}
    got_total, got = DetectionLoss(**loss)(heads, batch)
    want_total, want = rtrain.detection_loss(heads, batch, loss)
    assert set(want) == {"hm_loss", "wh_loss", "off_loss", "kp_loss"}
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6), k
    assert float(got_total) == pytest.approx(float(want_total), rel=1e-6)


def test_rotated_and_keypoint_decode(rotated_heads):
    from centernet_uda_torch.ops.decode import decode_detections

    heads, _ = rotated_heads
    dets, kps = decode_detections(heads["hm"], heads["wh"], heads["reg"],
                                  kps=heads["kps"], k=50, rotated=True,
                                  apply_sigmoid=True)
    top = rtrain.top_detections(heads, 50, 4)
    assert torch.allclose(dets[..., 5], top["scores"], rtol=0, atol=1e-7)
    assert torch.equal(dets[..., 6].long(), top["classes"])
    assert torch.allclose(dets[..., :4] * 4, top["boxes"][..., :4],
                          rtol=1e-6, atol=1e-4)
    assert torch.allclose(dets[..., 4], top["boxes"][..., 4], rtol=0,
                          atol=1e-4)
    assert torch.allclose(kps * 4, top["kps"], rtol=1e-6, atol=1e-4)


def test_angle_and_keypoint_gaps():
    """``angle_gap`` wraps the angle the shorter way round; ``kps_gap`` is
    the largest keypoint coordinate gap at the nearest box."""
    from perfbench import check

    heads = _bumps([(5, 5, 0.9), (20, 20, 0.7)])
    # the angle's logit at 179.5 degrees everywhere: sigmoid * 360 - 180
    z = math.log(359.5 / 0.5)
    heads["wh"] = torch.cat((heads["wh"], torch.full((1, 1, 32, 32), z)), 1)
    heads["kps"] = torch.zeros(1, 4, 32, 32)
    same = rtrain.top_detections(heads, 2, 4)
    nums = check.detection_numbers(same, heads, 2, 4)
    assert nums["angle_gap"] == 0 and nums["kps_gap"] == 0
    moved = {key: v.clone() for key, v in same.items()}
    moved["boxes"][..., 4] = -179.5
    moved["kps"][0, 1, 0, 1] += 2.0
    nums = check.detection_numbers(moved, heads, 2, 4)
    assert nums["angle_gap"] == pytest.approx(1.0, abs=1e-3)
    assert nums["kps_gap"] == pytest.approx(2.0, abs=1e-5)
    assert nums["box_gap"] == 0
    moved.pop("kps")
    assert check.detection_numbers(moved, heads, 2, 4)["kps_gap"] == math.inf


def test_a_nan_answer_is_never_within_its_limit():
    from perfbench import check

    heads = _bumps([(5, 5, 0.9), (20, 20, 0.7), (10, 26, 0.5)])
    heads["wh"] = torch.cat((heads["wh"], torch.zeros(1, 1, 32, 32)), 1)
    for col in (0, 4):
        dets = rtrain.top_detections(heads, 3, 4)
        dets["boxes"][0, 1, col] = math.nan
        nums = check.detection_numbers(dets, heads, 3, 4)
        assert math.isnan(nums["box_gap" if col == 0 else "angle_gap"])
        assert not check.judge(nums, dict.fromkeys(nums, 1e9))
