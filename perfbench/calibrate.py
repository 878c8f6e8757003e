"""Readings that the limits of ``perfbench/limits/`` are set from.

    python perfbench/calibrate.py --workload <name> --seeds 12 \
        [--control-seeds 3] [--seconds 2] [--out PATH]
    python perfbench/calibrate.py --config <file> --traffic <mix> ...

For each seed, in one process on the card: the cell's program run (its
entry at the cell's own sizes, with a short window) against the reference
(the lower readings), and for the first ``--control-seeds`` seeds the
control, the reference at TF32 put in the program's place, against the
reference in float32 (the upper readings); for a training cell also the
faults planted in the reference: half of the batch left out (the loss the
mean over the rest), and where the configuration has them the angle term
dropped (``angle_weight`` 0) and the keypoints' pair term dropped
(``kp_distance_weight`` 0); for eval and serving the faults planted in
the reference put in the program's place: a decode without peak
suppression, and where the configuration has them the angle negated and
the ``kps`` head zeroed. With ``--config`` and ``--traffic`` it reads a
configuration that no cell lists yet, under that mix (the readings a new
cell's limits start from). Besides the numbers that ``correct`` compares
it prints steadier candidates (per-step losses, median leaves, the heads'
scale and shift, ``peak_cover`` at shorter reaches), one JSON line per
reading, to standard output and to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from statistics import median

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def train_extra(prog: dict, ref: dict) -> dict:
    """Steadier candidates beside ``check.train_numbers``."""
    import torch

    from perfbench import check

    out = {}
    for i, (p, r) in enumerate(zip(prog["losses"], ref["losses"])):
        out[f"loss_step{i + 1}"] = max(abs(p[k] - r[k]) / abs(r[k])
                                       for k in r)
    g = ref["grad_norms"]
    gaps = [abs(prog["grad_norms"][n] - g[n]) / g[n] for n in g if g[n] > 0]
    out["grad_norm_median_leaf"] = median(gaps)
    mid = median(g.values())
    c = ref["change_norms"]
    gaps = [abs(prog["change_norms"][n] - c[n]) / c[n] for n in c
            if g[n] >= 1e-3 * mid and c[n] > 0]
    out["change_norm_median_leaf"] = median(gaps)
    init = {n: (torch.zeros_like(t) if n.endswith("mean")
                else torch.ones_like(t)) for n, t in ref["running"].items()}
    out["bn_stats_median_layer"] = median(
        check.running_gaps(prog["running"], ref["running"], init))
    return out


def heads_extra(prog: dict, ref: dict) -> dict:
    """The heads' scale (slope of the program's centred map on the
    reference's, less one), shift (mean gap over the reference's spread)
    and root-mean-square gap, worst head."""
    import torch

    scale = shift = rms = 0.0
    for n, r in ref.items():
        p = prog[n].to(r.device).double()
        r = r.double()
        mu = r.mean()
        rc, pc = r - mu, p - mu
        scale = max(scale, abs(float((pc * rc).sum() / (rc * rc).sum()) - 1))
        shift = max(shift, abs(float((p.mean() - mu) / rc.std())))
        rms = max(rms, float((p - r).pow(2).mean().sqrt() / rc.std()))
    del torch
    return {"heads_scale": scale, "heads_shift": shift, "heads_rms": rms}


def train_faults(ref: dict) -> dict:
    """The loss terms a training cell's faults drop, by the fault's name:
    the reference's ``loss`` with that term's weight at 0."""
    faults = {}
    if ref["heads"]["wh"] == 3:
        faults["fault_no_angle_term"] = "angle_weight"
    if ref["loss"].get("kp_indices"):
        faults["fault_no_pair_term"] = "kp_distance_weight"
    return {name: {**ref, "loss": {**ref["loss"], key: 0.0}}
            for name, key in faults.items()}


def eval_faults(ref: dict) -> dict:
    """The decodes of the eval and serving faults, by the fault's name."""
    from perfbench import check

    faults = {"fault_no_suppression": check.unsuppressed}
    if ref["heads"]["wh"] == 3:
        faults["fault_negated_angle"] = check.negated_angle
    if "kps" in ref["heads"]:
        faults["fault_zeroed_kps"] = check.zeroed_keypoints
    return faults


def unlisted(config: str, traffic: str) -> tuple:
    """The name and files of a cell that no entry lists: a configuration
    file and a mix (no limits: calibrate judges nothing)."""
    from perfbench import harness

    cfg = harness.load_json(ROOT / config)
    files = {"config": cfg,
             "mix": harness.load_json(harness.HERE / "mixes"
                                      / f"{traffic}.json")}
    return f"{cfg['name']}.{traffic}", files


def run(workload: str, seeds, control_seeds: int, seconds: float, out,
        device: str = "cuda", overrides=(), mix_overrides=None,
        files=None):
    import torch

    from perfbench import check, entries, harness
    from perfbench import weights as weights_lib

    if files is None:
        files = harness.cell_files(harness.with_waiting(harness.spec()),
                                   workload)
    if mix_overrides:
        files["mix"] = {**files["mix"], **mix_overrides}
    ref = files["config"]["reference"]
    entry = files["mix"]["entry"]
    ostd = float(files["mix"].get("offset_std", 0.5))
    net = check.make_net(ref)
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out is not None:
            with open(out, "a") as f:
                f.write(line + "\n")

    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        ctx = entries.Ctx(workload, files["config"], files["mix"], seed,
                          seconds, dev, overrides=list(overrides))
        o = entries.ENTRIES[entry](ctx)
        a = o.answers
        rec = {"workload": workload, "seed": seed, "side": "program"}
        if entry == "train":
            r = check.reference_train(ref, net.spec(), seed, a["batches"],
                                      dev, offset_std=ostd, steps=a["steps"])
            rec.update(check.train_numbers(a, r))
            rec.update(train_extra(a, r))
            rec["dcn_max_abs_dy"] = o.notes.get("dcn_max_abs_dy")
            emit(rec)
            if k < control_seeds:
                c = check.reference_train(ref, net.spec(), seed,
                                          a["batches"], dev, control=True,
                                          offset_std=ostd, steps=a["steps"])
                crec = {"workload": workload, "seed": seed,
                        "side": "control_tf32"}
                crec.update(check.train_numbers(c, r))
                crec.update(train_extra(c, r))
                emit(crec)
                half = check.reference_train(ref, net.spec(), seed,
                                             a["batches"], dev, half=True,
                                             offset_std=ostd,
                                             steps=a["steps"])
                hrec = {"workload": workload, "seed": seed,
                        "side": "fault_half_batch"}
                hrec.update(check.train_numbers(half, r))
                hrec.update(train_extra(half, r))
                emit(hrec)
                for side, broken in train_faults(ref).items():
                    f = check.reference_train(broken, net.spec(), seed,
                                              a["batches"], dev,
                                              offset_std=ostd,
                                              steps=a["steps"])
                    frec = {"workload": workload, "seed": seed,
                            "side": side}
                    frec.update(check.train_numbers(f, r))
                    frec.update(train_extra(f, r))
                    emit(frec)
        else:
            w = weights_lib.make(net.spec(), seed, dev, ostd, net.kinds)
            w.update({n: v.to(dev) for n, v in a["bn_stats"].items()})
            calls = a["calls"]

            def numbers(answers, reach=check.PEAK_REACH):
                if entry == "eval":
                    return check.eval_numbers(answers, net, w, a["cycle"],
                                              ref, dev, reach)
                return check.serve_numbers(answers, net, w, a["images"], ref,
                                           reach)

            def planted(**kw):
                """The sampled calls answered by the reference in the
                program's place (``check.control_answer``)."""
                out = []
                for c in calls:
                    if entry == "eval":
                        ans = check.control_answer(
                            net, w, a["cycle"][c["batch"]], ref, dev, **kw)
                        ans["batch"] = c["batch"]
                    else:
                        img = a["images"][c["image"]:c["image"] + 1]
                        ans = check.control_answer(
                            net, w, {"input": img}, ref, dev, serve=True,
                            **kw)
                        ans["image"] = c["image"]
                    out.append(ans)
                return out

            rec.update(numbers(calls))
            for reach in (1, 2, 4):
                rec[f"peak_cover_reach{reach}"] = numbers(
                    calls, reach)["peak_cover"]
            if entry == "eval":
                b = check.to_device(a["cycle"][calls[0]["batch"]], dev)
                rh = check.reference_heads(net, w, b["input"])
                rec.update(heads_extra(calls[0]["heads"], rh))
            rec["calls"] = o.attempted
            emit(rec)
            if k < control_seeds:
                ctl = planted()
                crec = {"workload": workload, "seed": seed,
                        "side": "control_tf32", **numbers(ctl)}
                if entry == "eval":
                    crec.update(heads_extra(ctl[0]["heads"], rh))
                emit(crec)
                for side, decode in eval_faults(ref).items():
                    emit({"workload": workload, "seed": seed, "side": side,
                          **numbers(planted(decode=decode, control=False))})
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
        del o, a
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    parser.add_argument("--workload")
    parser.add_argument("--config", help="a configuration file that no "
                        "cell lists (with --traffic)")
    parser.add_argument("--traffic")
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--first-seed", type=int, default=3_000_000_001)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    if (args.workload is None) == (args.config is None) or (
            args.config is None) != (args.traffic is None):
        parser.error("give --workload, or --config with --traffic")
    files = None
    workload = args.workload
    if args.config is not None:
        workload, files = unlisted(args.config, args.traffic)
    run(workload, seeds, args.control_seeds, args.seconds, args.out,
        files=files)
    return 0


if __name__ == "__main__":
    sys.exit(main())
