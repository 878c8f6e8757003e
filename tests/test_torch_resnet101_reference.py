"""``resnet101_rotated``: the port's ResNet-101 (rotated boxes, the
periodic angle term) against the benchmark's plain reference
``perfbench/reference/resnet.py``, on the CPU.

The port's ResNet-101 at its published widths, as the benchmark's
configuration composes it (``experiment=rotated``, float32), at batch 2,
with the benchmark's seeded weights loaded into both by name: the spec is
the port's state dict, name for name; eval-mode and train-mode heads at
80 px; every loss term, the angle term included, one step's gradients,
leaf by leaf, and the running statistics the harness folds from the
reference's at 64 px. At 80 px the trunk's maps run 40, 20, 10, 5, 3, so
the stride-2 3x3 convs meet even maps, where "SAME" pads (0, 1), and an
odd one, where it pads (1, 1) as torchvision does; the heads then come
out 24 x 24, not the targets' 20 x 20 (ResNet gives the targets' size
only at a multiple of 32 px), so the loss is taken at 64 px, whose maps
are all even. The reference padding as torchvision pads must fail. Then
whole CPU runs of ``harness.run_cell`` on the cell at 64 px (its own
limits, ``perfbench/limits/resnet101_rotated.train_512.json``): sound, and
with each fault planted in the program that the limits were calibrated
against on the card: the stride-2 3x3 convs padded (1, 1), the angle term
dropped, BatchNorm's running statistics left unmoved.

Tolerances. The reference runs the program's operations in the program's
order on the same CPU kernels (the port's ``Conv2d`` and ``SameConv2d`` are
``F.conv2d`` on the CPU, its train-mode BatchNorm ``F.batch_norm`` beside
``torch.var_mean``, the heads' biases added after the conv), so heads and
loss terms read 0 on an x86 CPU: heads are held to 1e-6 of each
head's largest magnitude and loss terms to a relative 1e-6, room for
float32 rounding alone should a kernel's order differ, far under the
torchvision padding's gap (above 1e-2 of the heads' scale). Gradients go
through BatchNorm's and the convolutions' backward, whose sums may be
ordered otherwise: each leaf is held to 1e-5 of the larger of its own and
the median leaf's norm (the check's ``grad_norm`` normalisation). The
folded running statistics are held to 1e-5 of their change, layer by
layer: the reference records them in float64 and the harness folds them
at the program's momentum 0.1, the program moves them in float32, whose
running variance near 1 rounds each entry by up to 6e-8 while a 0.1 step
moves it by a few hundredths.
"""

import json
import sys
import types
from pathlib import Path
from statistics import median

import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from centernet_uda_torch import config as config_lib  # noqa: E402
from centernet_uda_torch.models import common  # noqa: E402
from centernet_uda_torch.models import resnet as port_resnet  # noqa: E402
from centernet_uda_torch.train import CONFIG_DIR, build_trainer  # noqa: E402
from perfbench import check, gen, harness  # noqa: E402
from perfbench import weights as weights_lib  # noqa: E402
from perfbench.reference import train as rtrain  # noqa: E402

torch.set_num_threads(2)

CONFIG = json.loads((ROOT / "perfbench/configs/resnet101_rotated.json")
                    .read_text())
REF = CONFIG["reference"]
CELL = "resnet101_rotated.train_512"
SEED = 2 ** 33 + 101
HEADS_SIZE, SIZE, BATCH = 80, 64, 2
SMALL = {"input_size": SIZE, "batch": BATCH, "objects": [2, 4],
         "box_px": [8, 24]}


def compose():
    return config_lib.compose([f"experiment={CONFIG['experiment']}",
                               *CONFIG["overrides"]],
                              config_dir=str(CONFIG_DIR))


@pytest.fixture(scope="module")
def built():
    """The port's trainer, the reference net and the seed's weights,
    loaded into the port; a seeded batch of the cell's mix at 64 px, and
    seeded images at 80 px."""
    trainer = build_trainer(compose(), device="cpu")
    trainer.init_done()
    net = check.make_net(REF)
    w = weights_lib.make(net.spec(), SEED, "cpu", 0.0625, net.kinds)
    trainer.backend.module.load_state_dict(w)
    mix = {**harness.load_json(harness.HERE / "mixes" / "train_512.json"),
           **SMALL}
    batch = gen.batches(mix, SEED, REF["batch_size"], REF["heads"],
                        REF["max_detections"], False, "cpu")[0]
    batch = check.to_device(batch, "cpu")
    batch["images80"] = gen.images(SEED, 5, BATCH, HEADS_SIZE, "cpu")
    return trainer, net, w, batch


@pytest.fixture
def restored(built):
    """The port's module and the reference's padding as the fixture made
    them, after the test: a train-mode forward moves the running
    statistics."""
    trainer, net = built[0], built[1]
    module = trainer.backend.module
    before = {n: t.clone() for n, t in module.state_dict().items()}
    yield built
    module.zero_grad(set_to_none=True)
    module.load_state_dict(before)
    net.padding = "same"


def assert_heads_close(prog, ref):
    assert set(prog) == set(ref) == set(REF["heads"])
    for name in ref:
        scale = float(ref[name].abs().max())
        torch.testing.assert_close(prog[name], ref[name], rtol=0,
                                   atol=1e-6 * scale)


def heads_gap(prog, ref):
    return max(float((prog[k] - ref[k]).abs().max() / ref[k].abs().max())
               for k in ref)


def test_spec_is_the_ports_state_dict(built):
    trainer, net, _, _ = built
    state = trainer.backend.module.state_dict()
    assert [(n, tuple(t.shape)) for n, t in state.items()] == [
        (n, tuple(s)) for n, s, _ in net.spec()]
    assert net.kinds == {} and net.dcn_shapes is None
    assert len(net.blocks()) == 33
    bns = [n for n, _, k in net.spec() if n.endswith("running_mean")]
    assert len(bns) == 107  # 104 in the trunk, 3 in the neck


def test_reference_section_is_the_composed_config():
    """What the spec test does not hold: the depth table, the head and
    neck widths, against the port's configuration and its module."""
    cfg = compose()
    params = cfg.model.backend.params
    assert cfg.model.backend.name == REF["backend"]["name"] == "resnet"
    assert int(params.num_layers) == REF["backend"]["num_layers"] == 101
    net = check.make_net(REF)
    kind, stages, width = port_resnet.RESNET_CONFIGS[101]
    assert kind == "bottleneck" and net.depths == stages
    assert REF["head_conv"] == port_resnet.HEAD_CONV == 64
    assert REF["deconv_channels"] == [256, 256, 256]
    assert width == 2048 and bool(params.rotated_boxes)
    assert REF["heads"]["wh"] == 3 and REF["loss"]["periodic"] is True


def test_the_maps_meet_even_and_odd_sizes(built):
    """At 80 px the stride-2 3x3 convs see 20, 10 and 5: "SAME" pads
    (0, 1) on the first two and (1, 1) on the last."""
    trainer = built[0]
    seen = []
    convs = [m for m in trainer.backend.module.modules()
             if isinstance(m, common.SameConv2d)]
    handles = [m.register_forward_pre_hook(
        lambda m, a: seen.append(a[0].shape[-1])) for m in convs]
    try:
        with torch.no_grad():
            trainer.backend.module.eval()(built[3]["images80"])
    finally:
        for h in handles:
            h.remove()
    assert seen == [20, 10, 5]
    assert [common.same_padding(n, 3, 2) for n in seen] == [
        (0, 1), (0, 1), (1, 1)]


def test_eval_heads(built):
    trainer, net, w, batch = built
    module = trainer.backend.module
    module.eval()
    x = batch["images80"]
    with torch.no_grad():
        prog = module(x)
        assert_heads_close(prog, net.forward(w, x, "eval"))
    assert prog["hm"].shape[-1] == 24


def test_train_heads(restored):
    trainer, net, w, batch = restored
    module = trainer.backend.module
    module.train()
    x = batch["images80"]
    with torch.no_grad():
        assert_heads_close(module(x), net.forward(w, x, "train"))


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("key", ["images80", "input"])
def test_torchvision_padding_is_not_the_program(restored, mode, key):
    """The reference padded (1, 1) at stride 2, as torchvision pads, is
    far from the program: the even maps shift by a pixel."""
    trainer, net, w, batch = restored
    module = trainer.backend.module
    module.train(mode == "train")
    net.padding = "torchvision"
    x = batch[key]
    with torch.no_grad():
        far = net.forward(w, x, mode)
        net.padding = "same"
        near = net.forward(w, x, mode)
        prog = module(x)
    assert heads_gap(prog, near) <= 1e-6
    assert heads_gap(prog, far) > 1e-2


def test_folded_running_statistics(restored):
    """A judged step's ``calib`` forward records the batch statistics,
    which the harness folds at 0.1, the program's momentum."""
    trainer, net, w, batch = restored
    module = trainer.backend.module
    module.train()
    with torch.no_grad():
        module(batch["input"])
    P = {n: t.clone().requires_grad_(n.endswith(("weight", "bias")))
         for n, t in w.items()}
    net.forward(P, batch["input"], "calib")
    folded = check._fold_running(w, net.stats, None)
    assert len(folded) == 2 * 107
    after = module.state_dict()
    for name, value in folded.items():
        change = (value - w[name].double()).norm()
        gap = (after[name].double() - value).norm()
        assert float(gap) <= 1e-5 * float(change), name


def test_loss_terms_and_gradients(restored):
    trainer, net, w, batch = restored
    module = trainer.backend.module
    module.train()
    module.zero_grad(set_to_none=True)
    heads = module(batch["input"])
    loss, stats = trainer.centernet_loss(heads, batch)
    loss.backward()
    names = [n for n, _ in module.named_parameters()]
    prog_grads = {n: p.grad for n, p in module.named_parameters()}
    leaves = {n: w[n].clone().requires_grad_(True) for n in names}
    ref_heads = net.forward({**w, **leaves}, batch["input"], "train")
    ref_loss, terms = rtrain.detection_loss(ref_heads, batch, REF["loss"])
    assert set(terms) == {"hm_loss", "wh_loss", "off_loss"}
    for k, v in terms.items():
        torch.testing.assert_close(stats[k].detach(), v.detach(), rtol=1e-6,
                                   atol=0)
    torch.testing.assert_close(loss.detach(), ref_loss.detach(), rtol=1e-6,
                               atol=0)
    # the angle term alone: each side's size term less its size L1
    loss_fn = trainer.centernet_loss
    loss_fn.angle_weight = 0.0
    try:
        _, plain = loss_fn({k: v.detach() for k, v in heads.items()}, batch)
    finally:
        loss_fn.angle_weight = REF["loss"]["angle_weight"]
    _, ref_plain = rtrain.detection_loss(
        {k: v.detach() for k, v in ref_heads.items()}, batch,
        {**REF["loss"], "angle_weight": 0.0})
    angle = float(stats["wh_loss"].detach() - plain["wh_loss"])
    ref_angle = float(terms["wh_loss"].detach() - ref_plain["wh_loss"])
    assert angle > 0.1 * float(stats["wh_loss"].detach())
    assert angle == pytest.approx(ref_angle, rel=1e-5)
    grads = torch.autograd.grad(ref_loss, [leaves[n] for n in names])
    norms = {n: float(g.norm()) for n, g in zip(names, grads)}
    mid = median(norms.values())
    for n, g in zip(names, grads):
        gap = float((prog_grads[n] - g).norm())
        assert gap <= 1e-5 * max(norms[n], mid), n


# ----------------------------------------------------------------------
# whole CPU runs of the cell, sound and with a fault planted in the
# program (the faults its limits were calibrated against on the card)
# ----------------------------------------------------------------------
def torchvision_padding(trainer):
    """The stride-2 3x3 convs padded (1, 1), as torchvision pads."""
    for m in trainer.backend.module.modules():
        if isinstance(m, common.SameConv2d):
            m.padding = (1, 1)
            m.forward = types.MethodType(common.Conv2d.forward, m)


def no_angle_term(trainer):
    trainer.centernet_loss.angle_weight = 0.0


def unmoved_running_statistics(trainer):
    for m in trainer.backend.module.modules():
        if isinstance(m, common.BatchNorm2d):
            m.momentum = 0.0


FAULTS = [torchvision_padding, no_angle_term, unmoved_running_statistics]


@pytest.fixture
def run(monkeypatch):
    """``harness.run_cell`` on the cell at 64 px on the CPU. This suite's
    conftest loads JAX for the parity tests, which a benchmark run refuses
    (``harness.refuse_forbidden``); that refusal is held by
    ``perfbench/tests/test_perfbench_imports.py`` and left out here."""
    monkeypatch.setattr(harness, "refuse_forbidden", lambda: None)

    def cell(patch=None):
        return harness.run_cell(CELL, SEED, 0.5, False, device="cpu",
                                mix_overrides=SMALL, patch=patch,
                                emit=False)
    return cell


def test_torchvision_padding_patch_pads_one_each_side(built):
    trainer = built[0]
    x = torch.randn(1, 128, 20, 20)
    conv = [m for m in trainer.backend.module.modules()
            if isinstance(m, common.SameConv2d)][0]
    want = F.conv2d(x, conv.weight, None, 2, 1)
    state = conv.padding, conv.forward
    torchvision_padding(types.SimpleNamespace(backend=types.SimpleNamespace(
        module=torch.nn.Sequential(conv))))
    try:
        torch.testing.assert_close(conv(x), want, rtol=0, atol=0)
    finally:
        conv.padding = state[0]
        del conv.forward


def test_the_cell_is_correct_on_the_cpu(run):
    result = run()
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"loss", "grad_norm", "change_norm",
                                     "bn_stats"}


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_planted_fault_is_not_correct(run, fault):
    assert not run(fault)["correct"]


def test_conv_roofline_reads_the_conv_family_alone():
    """``conv_roofline.train``: the traced items' model FLOPs at the peak
    over the device time of the kernels ``perfbench/kernels/conv/`` names;
    nothing where the run has no such kernel, no peak or another entry.
    BatchNorm's and Adam's kernels are not of the family."""
    from perfbench.trace import Summary

    family = harness.kernel_family("conv")
    assert family and not set(family) & set(harness.kernel_family(
        "batchnorm"))
    conv = family[0]
    names = [f"void {conv}<128>(float const*)", "bn_fw_tr_1C11_kernel_NCHW",
             "void at::native::multi_tensor_apply_kernel<Adam>()"]
    assert not any(p in n for p in family for n in names[1:])
    events = [{"cat": "kernel", "ts": 2e6 * i, "dur": 1e6 * (i + 1),
               "name": n} for i, n in enumerate(names)]
    rec = {"entry": "train", "summary": Summary(events, 10.0), "items": 8,
           "flops_per_item": 2.5e12, "peak_flops": 40e12,
           "kernel_family": harness.kernel_family}
    reader = harness.load_reader("conv_roofline.train")
    # 8 x 2.5e12 / 40e12 = 0.5 s at the peak over 1 s of conv kernels
    assert reader.read(rec) == pytest.approx(50.0)
    assert reader.read({**rec, "entry": "eval"}) is None
    assert reader.read({**rec, "peak_flops": None}) is None
    assert reader.read({**rec, "summary": Summary(events[1:], 10.0)}) is None
