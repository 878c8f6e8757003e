"""On the card: each cell's control, the reference at TF32 put in the
program's place at the cell's own size, must come out not correct on three
seeds, and the program's run correct on them; for eval and serving so must
the reference put in the program's place with a decode that leaves out
peak suppression.

    python -m pytest perfbench/tests -m gpu -q -p no:cacheprovider
"""

import pytest
import torch

from perfbench import check, entries, harness
from perfbench import weights as weights_lib

SEEDS = (3_100_000_007, 3_100_000_019, 3_100_000_031)
# the benchmark's cells and those waiting in perfbench/waiting/
BENCH = harness.with_waiting(harness.spec())
CELLS = [w["name"] for w in BENCH["workloads"]]


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(workload):
    needs_card()
    dev = torch.device("cuda")
    files = harness.cell_files(BENCH, workload)
    ref = files["config"]["reference"]
    limits = files["limits"]["limits"]
    entry = files["mix"]["entry"]
    ostd = float(files["mix"].get("offset_std", 0.5))
    net = check.make_net(ref)
    for seed in SEEDS:
        ctx = entries.Ctx(workload, files["config"], files["mix"], seed, 2.0,
                          dev)
        a = entries.ENTRIES[entry](ctx).answers
        if entry == "train":
            r = check.reference_train(ref, net.spec(), seed, a["batches"],
                                      dev, offset_std=ostd, steps=a["steps"])
            program = check.train_numbers(a, r)
            c = check.reference_train(ref, net.spec(), seed, a["batches"],
                                      dev, control=True, offset_std=ostd,
                                      steps=a["steps"])
            control = check.train_numbers(c, r)
        else:
            w = weights_lib.make(net.spec(), seed, dev, ostd, net.kinds)
            w.update({n: v.to(dev) for n, v in a["bn_stats"].items()})
            if entry == "eval":
                program = check.eval_numbers(a["calls"], net, w, a["cycle"],
                                             ref, dev)
                ctl = [dict(check.control_answer(
                    net, w, a["cycle"][c["batch"]], ref, dev),
                    batch=c["batch"]) for c in a["calls"]]
                control = check.eval_numbers(ctl, net, w, a["cycle"], ref,
                                             dev)
                fault = [dict(check.control_answer(
                    net, w, a["cycle"][c["batch"]], ref, dev,
                    decode=check.unsuppressed, control=False),
                    batch=c["batch"]) for c in a["calls"]]
                fault = check.eval_numbers(fault, net, w, a["cycle"], ref,
                                           dev)
            else:
                program = check.serve_numbers(a["calls"], net, w,
                                              a["images"], ref)
                ctl = [dict(check.control_answer(
                    net, w, {"input": a["images"][c["image"]:c["image"] + 1]},
                    ref, dev, serve=True), image=c["image"])
                    for c in a["calls"]]
                control = check.serve_numbers(ctl, net, w, a["images"], ref)
                fault = [dict(check.control_answer(
                    net, w, {"input": a["images"][c["image"]:c["image"] + 1]},
                    ref, dev, serve=True, decode=check.unsuppressed,
                    control=False), image=c["image"]) for c in a["calls"]]
                fault = check.serve_numbers(fault, net, w, a["images"], ref)
            assert not check.judge(fault, limits), (seed, fault)
        assert check.judge(program, limits), (seed, program)
        assert not check.judge(control, limits), (seed, control)
