"""``b3_coco_merged``: the port's EfficientNet-b3 (skips, rotated boxes,
five keypoints) against the plain reference ``perfbench/reference/
efficientnet.py``, on the CPU.

The port's b3 at its published widths, at 64 px and batch 2, with the
benchmark's seeded weights loaded into both by name: the spec is the
port's state dict, name for name; eval-mode heads; train-mode heads at a
given step, whose stochastic-depth draws are the program's bit for bit;
the running statistics the harness folds from the reference's; the loss
terms, the angle term and ``kp_loss`` included; the gradients of one
step. Then whole CPU runs of ``harness.run_cell`` on the cell (its own
limits, ``perfbench/limits/b3_coco_merged.train_512.json``): sound, and
with each fault planted in the program: stochastic depth off, the masks
drawn at the next step's seed, the angle term dropped, the keypoints'
pair term dropped.

Tolerances. The reference runs the program's operations in the program's
order on the same CPU kernels, so heads, draws and loss terms read 0 on
the builder's CPU: heads are held to 1e-6 of each head's largest
magnitude and loss terms to a relative 1e-6, room for float32 rounding
alone should a kernel's order differ, far under the 1e-2 and more that a
dropped or misplaced mask makes (``test_train_heads``). Gradients go
through BatchNorm's and the convolutions' backward, whose sums may be
ordered otherwise: each leaf is held to 1e-5 of the larger of its own
and the median leaf's norm (the check's ``grad_norm`` normalisation),
where the card's limit is far wider. The folded running statistics are
held to 3e-5 of their change, layer by layer: the reference records them
in float64, the program moves them in float32, whose running variance
near 1 rounds each entry by up to 6e-8 while a 0.01 step changes it by a
few thousandths (it reads 3e-6 on the builder's CPU).
"""

import json
from statistics import median

import pytest
import torch

from centernet_uda_torch import config as config_lib
from centernet_uda_torch.models import efficientnet as port_effnet
from centernet_uda_torch.train import CONFIG_DIR, build_trainer
from perfbench import check, gen, harness
from perfbench import weights as weights_lib
from perfbench.reference import train as rtrain

ROOT = harness.ROOT
CONFIG = json.loads((ROOT / "perfbench/configs/b3_coco_merged.json")
                    .read_text())
REF = CONFIG["reference"]
CELL = "b3_coco_merged.train_512"
SEED = 2 ** 33 + 101
SIZE, BATCH = 64, 2
SMALL = {"input_size": SIZE, "batch": BATCH, "objects": [2, 4],
         "box_px": [8, 24]}
STEP = 3


def compose():
    return config_lib.compose([f"experiment={CONFIG['experiment']}",
                               *CONFIG["overrides"]],
                              config_dir=str(CONFIG_DIR))


@pytest.fixture(scope="module")
def built():
    """The port's trainer, the reference net and the seed's weights,
    loaded into the port; a seeded batch of the cell's mix at 64 px."""
    trainer = build_trainer(compose(), device="cpu")
    trainer.init_done()
    net = check.make_net(REF)
    w = weights_lib.make(net.spec(), SEED, "cpu", 0.0625, net.kinds)
    trainer.backend.module.load_state_dict(w)
    mix = {**harness.load_json(harness.HERE / "mixes" / "train_512.json"),
           **SMALL}
    batch = gen.batches(mix, SEED, REF["batch_size"], REF["heads"],
                        REF["max_detections"], False, "cpu")[0]
    return trainer, net, w, check.to_device(batch, "cpu")


def train_forward(fn):
    """``fn()``'s result and every ``torch.rand`` it drew, in order."""
    drawn = []
    real = torch.rand

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        drawn.append(out.clone())
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(torch, "rand", recording)
    try:
        return fn(), drawn
    finally:
        mp.undo()


@pytest.fixture
def restored(built):
    """The port's module as the fixture loaded it, after the test: a
    train-mode forward moves its running statistics."""
    module = built[0].backend.module
    before = {n: t.clone() for n, t in module.state_dict().items()}
    yield built
    module.zero_grad(set_to_none=True)
    module.load_state_dict(before)


def program_train(trainer, x, step):
    trainer.global_step = step
    trainer._seed_drop_generator()
    module = trainer.backend.module
    module.train()
    return module(x)


def assert_heads_close(prog, ref):
    assert set(prog) == set(ref) == set(REF["heads"])
    for name in ref:
        scale = float(ref[name].abs().max())
        torch.testing.assert_close(prog[name], ref[name], rtol=0,
                                   atol=1e-6 * scale)


def test_spec_is_the_ports_state_dict(built):
    trainer, net, _, _ = built
    state = trainer.backend.module.state_dict()
    assert [(n, tuple(t.shape)) for n, t in state.items()] == [
        (n, tuple(s)) for n, s, _ in net.spec()]
    assert net.kinds == {} and net.dcn_shapes is None
    assert len(net.blocks) == 26


def test_reference_section_is_the_composed_config():
    """What the spec test does not hold: the stochastic-depth seed, the
    neck's widths, the skips and the block table, against the port's
    configuration and its module's tables."""
    cfg = compose()
    params = cfg.model.backend.params
    assert REF["seed"] == int(cfg.seed)
    assert REF["use_skip"] == bool(params.use_skip)
    assert not params.get("use_upsample")
    assert REF["head_conv"] == int(params.get("num_head_channels") or 256)
    assert REF["deconv_channels"] == list(
        params.get("num_deconv_channels") or (256, 256, 256))
    net = check.make_net(REF)
    variant = REF["backend"]["variant"]
    assert net.blocks == port_effnet.block_specs(variant)
    assert dict(net.skips) == port_effnet.SKIP_MAPPINGS[variant]


def test_eval_heads(built):
    trainer, net, w, batch = built
    module = trainer.backend.module
    module.eval()
    with torch.no_grad():
        assert_heads_close(module(batch["input"]),
                           net.forward(w, batch["input"], "eval"))


def test_train_heads(restored):
    """At a given step the reference draws the program's stochastic-depth
    numbers bit for bit, so its heads are the program's; at the next step,
    or without a step, they are not."""
    trainer, net, w, batch = restored
    x = batch["input"]
    with torch.no_grad():
        prog, p_draws = train_forward(
            lambda: program_train(trainer, x, STEP))
        ref, r_draws = train_forward(
            lambda: net.forward(w, x, "train", STEP))
        other = net.forward(w, x, "train", STEP + 1)
        plain = net.forward(w, x, "train")
    blocks = [i for i, (_, cin, cout, _, stride) in enumerate(net.blocks)
              if stride == 1 and cin == cout and net.drop_rate(i) > 0]
    assert len(p_draws) == len(r_draws) == len(blocks) == 19
    for a, b in zip(p_draws, r_draws):
        assert a.shape == (BATCH, 1, 1, 1) and torch.equal(a, b)
    assert_heads_close(prog, ref)
    for far in (other, plain):
        assert max(float((far[k] - ref[k]).abs().max()
                         / ref[k].abs().max()) for k in ref) > 1e-2


def test_folded_running_statistics(restored):
    """A judged step's ``calib`` forward records what the harness folds
    at 0.1 into the program's 0.01 step of the running statistics."""
    trainer, net, w, batch = restored
    with torch.no_grad():
        program_train(trainer, batch["input"], STEP)
    P = {n: t.clone().requires_grad_(n.endswith(("weight", "bias")))
         for n, t in w.items()}
    net.forward(P, batch["input"], "calib", STEP)
    folded = check._fold_running(w, net.stats, None)
    after = trainer.backend.module.state_dict()
    for name, value in folded.items():
        change = (value - w[name].double()).norm()
        gap = (after[name].double() - value).norm()
        assert float(gap) <= 3e-5 * float(change), name


def test_loss_terms_and_gradients(restored):
    trainer, net, w, batch = restored
    module = trainer.backend.module
    module.zero_grad(set_to_none=True)
    heads = program_train(trainer, batch["input"], STEP)
    loss, stats = trainer.centernet_loss(heads, batch)
    loss.backward()
    names = [n for n, _ in module.named_parameters()]
    prog_grads = {n: p.grad for n, p in module.named_parameters()}
    leaves = {n: w[n].clone().requires_grad_(True) for n in names}
    ref_heads = net.forward({**w, **leaves}, batch["input"], "train", STEP)
    ref_loss, terms = rtrain.detection_loss(ref_heads, batch, REF["loss"])
    assert set(terms) == {"hm_loss", "wh_loss", "off_loss", "kp_loss"}
    for k, v in terms.items():
        torch.testing.assert_close(stats[k].detach(), v.detach(), rtol=1e-6,
                                   atol=0)
    torch.testing.assert_close(loss.detach(), ref_loss.detach(), rtol=1e-6,
                               atol=0)
    grads = torch.autograd.grad(ref_loss, [leaves[n] for n in names])
    norms = {n: float(g.norm()) for n, g in zip(names, grads)}
    mid = median(norms.values())
    for n, g in zip(names, grads):
        gap = float((prog_grads[n] - g).norm())
        assert gap <= 1e-5 * max(norms[n], mid), n


def run(patch=None):
    return harness.run_cell(CELL, SEED, 0.5, False, device="cpu",
                            mix_overrides=SMALL, patch=patch, emit=False)


def no_stochastic_depth(trainer):
    trainer.drop_generator = None
    trainer.backend.module.drop_generator = None


def masks_of_the_next_step(trainer):
    inner = trainer._seed_drop_generator

    def seed():
        trainer.global_step += 1
        try:
            inner()
        finally:
            trainer.global_step -= 1

    trainer._seed_drop_generator = seed


def no_angle_term(trainer):
    trainer.centernet_loss.angle_weight = 0.0


def no_pair_term(trainer):
    trainer.centernet_loss.kp_indices = None


def test_the_cell_is_correct_on_the_cpu():
    result = run()
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"loss", "grad_norm", "change_norm",
                                     "bn_stats"}


@pytest.mark.parametrize("fault", [no_stochastic_depth,
                                   masks_of_the_next_step, no_angle_term,
                                   no_pair_term],
                         ids=lambda f: f.__name__)
def test_a_planted_fault_is_not_correct(fault):
    assert not run(fault)["correct"]
