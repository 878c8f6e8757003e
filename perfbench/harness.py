"""One run of one cell: the spec read from ``BENCHMARK.json``, the entry
driven, the per-layer readers run over its trace, the answers judged, and
the result line printed.

Everything a cell needs is found by name: the configuration's file
(``configs`` in ``BENCHMARK.json``), the mix ``perfbench/mixes/<traffic>
.json``, the limits ``perfbench/limits/<workload>.json``, a reader
``perfbench/metrics/<metric>.py`` for each per-layer metric, and the kernel
families ``perfbench/kernels/<family>/*.txt`` that readers look up.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "centernet_uda_tpu")


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's records (the
    interpreter's start included)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        stat = Path("/proc/self/stat").read_text()
        start = int(stat.rsplit(")", 1)[1].split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - start, 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_loaded(modules: Sequence[str]) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of ``FORBIDDEN``, compared whole."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def refuse_forbidden() -> None:
    """Exit with 3, naming them on standard error, where modules of JAX or
    of the JAX package are loaded in this process."""
    found = forbidden_loaded(list(sys.modules))
    if found:
        print(f"perfbench: modules of another package loaded in this run: "
              f"{found}", file=sys.stderr)
        raise SystemExit(3)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def with_waiting(bench: dict) -> dict:
    """``bench`` with the cells of ``perfbench/waiting/*.json`` added: cells
    whose files are all here but that ``BENCHMARK.json`` does not list yet
    (each file holds the ``workloads``, ``end_to_end`` metrics without a
    bound, and ``per_layer`` entries to copy in). The tests drive them."""
    out = {k: list(v) if isinstance(v, list) else v for k, v in bench.items()}
    for path in sorted((HERE / "waiting").glob("*.json")):
        extra = load_json(path)
        for key in ("workloads", "end_to_end", "per_layer"):
            out[key] += extra.get(key, [])
    return out


def cell_files(bench: dict, workload: str) -> dict:
    """The cell's entry, configuration, mix and limits."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    mix = load_json(HERE / "mixes" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    return {"cell": cell, "config": config, "mix": mix, "limits": limits}


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec_ = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module


def kernel_family(family: str) -> List[str]:
    """The kernel-name patterns of a family: every line of every
    ``perfbench/kernels/<family>/*.txt``, blank lines and ``#`` comments
    left out."""
    out = []
    for path in sorted((HERE / "kernels" / family).glob("*.txt")):
        for line in path.read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                out.append(line)
    return out


def device_record(device, chips: int, peak: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": peak}


def layer_records(files: dict, outcome, summary, device) -> dict:
    """What the per-layer readers read, for a traced run."""
    import torch

    from perfbench import counts
    from perfbench.check import make_net
    from perfbench.gen import batch_size

    ref = files["config"]["reference"]
    mix = files["mix"]
    entry = mix["entry"]
    net = make_net(ref)
    size = int(mix["input_size"])
    b = batch_size(mix, ref["batch_size"])
    domains = int(ref.get("domains", 1)) if entry == "train" else 1
    train = entry == "train"
    fwd = counts.forward_flops(net, size)
    shapes = counts.dcn_shapes(net, b, size)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    peaks = counts.peaks_for(name)
    precision = files["config"].get("precision", "float32")
    peak_key = {"float32": "fp32_flops", "bfloat16": "bf16_flops"}[precision]
    per_call = b if entry != "serve" else 1
    return {
        "entry": entry,
        "summary": summary,
        "items": outcome.items_traced,
        "flops_per_item": fwd * (3 if train else 1) * domains,
        "peak_flops": None if peaks is None else peaks[peak_key],
        "dcn_least_s_per_item": (None if peaks is None else
                                 domains * counts.least_seconds(
                                     shapes, train, peaks) / per_call),
        "kernel_family": kernel_family,
        "spans": outcome.spans,
    }


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: Sequence[str] = (),
             mix_overrides: Optional[dict] = None,
             patch: Optional[Callable] = None,
             process_start: Optional[float] = None,
             emit: bool = True) -> dict:
    """Run ``workload`` once; returns the result and, with ``emit``,
    prints the checks on stderr and the result line on stdout."""
    import torch

    from perfbench import check
    from perfbench import entries
    from perfbench.trace import Tracer

    if process_start is None:
        process_start = time.perf_counter() - process_age_s()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = spec()
    files = cell_files(bench, workload)
    if mix_overrides:
        files["mix"] = {**files["mix"], **mix_overrides}
    dev = torch.device(device)
    tracer = None
    if trace:
        tracer = Tracer(ROOT / "build" / "perfbench" / "traces"
                        / f"{workload}.json", 0.3 * seconds,
                        min(3.0, 0.3 * seconds))
    ctx = entries.Ctx(workload, files["config"], files["mix"], int(seed),
                      float(seconds), dev, tracer, list(overrides), patch)
    outcome = entries.ENTRIES[files["mix"]["entry"]](ctx)
    setup_s = outcome.notes["window_start"] - process_start

    refuse_forbidden()

    summary = tracer.summary() if tracer is not None else None
    ref = files["config"]["reference"]
    net = check.make_net(ref)
    entry = files["mix"]["entry"]
    answers = outcome.answers
    if entry == "train":
        ref_out = check.reference_train(
            ref, net.spec(), seed, answers["batches"], dev,
            offset_std=float(files["mix"].get("offset_std", 0.5)))
        numbers = check.train_numbers(answers, ref_out)
    else:
        from perfbench import weights as weights_lib

        w = weights_lib.make(net.spec(), seed, dev,
                             float(files["mix"].get("offset_std", 0.5)))
        w.update({k: v.to(dev) for k, v in answers["bn_stats"].items()})
        if entry == "eval":
            numbers = check.eval_numbers(answers["calls"], net, w,
                                         answers["cycle"], ref, dev)
        else:
            numbers = check.serve_numbers(answers["calls"], net, w,
                                          answers["images"], ref)
    limits = files["limits"]["limits"]
    correct = bool(check.judge(numbers, limits)) and outcome.failed == 0

    metrics: Dict[str, dict] = {}
    breakdown = None
    if not trace:
        values = {"setup_s": setup_s, **outcome.e2e}
        for m in bench["end_to_end"]:
            if applies(m, workload) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    elif summary is not None:
        rec = layer_records(files, outcome, summary, dev)
        for m in bench["per_layer"]:
            if not applies(m, workload):
                continue
            value = load_reader(m["name"]).read(rec)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": summary.top_ops(),
                     "idle_gaps": summary.idle_gaps()}

    device_rec = device_record(dev, int(files["cell"]["chips"]),
                               outcome.memory_peak)
    if summary is not None:
        device_rec["busy_s"] = summary.busy_s
        device_rec["window_s"] = summary.window_s
    result = {"correct": correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics,
              "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # a gap that is not finite (an answer of the wrong shape) is named, so
    # the line stays strict JSON
    result["checks"] = {k: {"value": numbers[k] if math.isfinite(numbers[k])
                            else str(numbers[k]), "limit": limits[k]}
                        for k in limits}
    if emit:
        # again just before the result: the reference and the readers ran
        # since the first look
        refuse_forbidden()
        notes = {k: v for k, v in outcome.notes.items()
                 if k != "window_start"}
        print(f"perfbench {workload} seed {seed}: {json.dumps(notes)}",
              file=sys.stderr)
        for k in limits:
            print(f"check {k}: {numbers[k]!r} limit {limits[k]!r}",
                  file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(result, allow_nan=False), flush=True)
    return result
