"""Pins that fail on any moved reading of the benchmark's cells: digests
of the weights and of the batches the harness makes from a seed, and the
numbers ``correct`` compares in one small CPU run of each entry, recorded
from the harness before it took a configuration's net by name. A change
to the harness that leaves the cells' readings as they are keeps them.

The numbers are exact for this torch build on the CPU at two threads
(``conftest.py``); the runs are those of ``test_perfbench_faults.py``,
with a window that holds one call, so the sampled answers do not depend
on the machine's speed.
"""

import hashlib

import numpy as np
import pytest
import torch

from perfbench import gen, harness
from perfbench import weights as weights_lib
from perfbench.check import make_net

SEED = 2 ** 33 + 101
SMALL = {"input_size": 64, "batch": 1, "objects": [2, 4], "box_px": [8, 24]}
DLA = harness.load_json(harness.HERE / "configs"
                        / "dla34_baseline.json")["reference"]

WEIGHTS = "2a80242205271d33b5f64499a17ad232985c89fdb5da2982e5eb48feaebcf9bb"
# at the small size both mixes make the same batches
PLAIN = "a8ef680247d9c11ddb5a34353688fd0d594957e0f4c8286dfd5bfef9ca0b0da3"
UDA = "7c62d205e583210e2a42218f02d0e03d8347c57562474902e3e5d4b67e96b2ef"
CHECKS = {
    "dla34_baseline.train_512": {
        "loss": 9.22840051332055e-08,
        "grad_norm": 0.0024483398435004283,
        "change_norm": 0.029896843364324032,
        "bn_stats": 5.210489648847348e-07},
    "dla34_entmin.train_512": {
        "loss": 9.22840051332055e-08,
        "grad_norm": 0.002448338844238265,
        "change_norm": 0.023183349840431612,
        "bn_stats": 3.4434719661755624e-07},
    "dla34_baseline.eval_800": {
        "heads": 1.8248671551646112e-07,
        "det_score_gap": 2.980232238769531e-07,
        "box_gap": 0.0,
        "peak_cover": 0.0},
    # 128 px: the served k = 150 needs more peaks than a 16 x 16 map has
    "dla34_baseline.serve_b1": {
        "det_score_gap": 2.980232238769531e-07,
        "box_gap": 0.0,
        "peak_cover": 0.0},
}


def digest(named) -> str:
    """sha256 over each (name, tensor or array): its name, dtype, shape
    and bytes."""
    h = hashlib.sha256()
    for name, v in named:
        a = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        h.update(f"{name}|{a.dtype}|{a.shape}|".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def test_weights_digest():
    net = make_net(DLA)
    w = weights_lib.make(net.spec(), SEED, "cpu", kinds=net.kinds)
    assert digest(w.items()) == WEIGHTS


@pytest.mark.parametrize("mix", ["train_512", "eval_800"])
@pytest.mark.parametrize("target_domain", [False, True])
def test_batches_digest(mix, target_domain):
    m = {**harness.load_json(harness.HERE / "mixes" / f"{mix}.json"),
         **SMALL}
    cycle = gen.batches(m, SEED, DLA["batch_size"], DLA["heads"],
                        DLA["max_detections"], target_domain, "cpu")
    got = digest((f"{i}.{k}", b[k]) for i, b in enumerate(cycle)
                 for k in sorted(b))
    assert got == (UDA if target_domain else PLAIN)


@pytest.mark.parametrize("workload", sorted(CHECKS))
def test_checks_numbers(workload, monkeypatch):
    bench = harness.with_waiting(harness.spec())
    monkeypatch.setattr(harness, "spec", lambda: bench)
    size = {"input_size": 128} if workload.endswith("serve_b1") else {}
    r = harness.run_cell(workload, SEED, 1e-3, False, device="cpu",
                         overrides=["dcn_impl=cuda"],
                         mix_overrides={**SMALL, **size}, emit=False)
    assert r["correct"] and r["attempted"] == 1
    assert {k: v["value"] for k, v in r["checks"].items()} == \
        CHECKS[workload]
