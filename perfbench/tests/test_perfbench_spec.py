"""BENCHMARK.json against the benchmark's contract, and each cell's files."""

import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# with the cells that wait in perfbench/waiting/
ALL = harness.with_waiting(BENCH)
E2E = {m["name"]: m for m in ALL["end_to_end"]}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["moves"] in E2E
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert "setup_s" in E2E


def test_run_seconds_fit_the_full_check():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in ALL["workloads"]])
def test_cell_files_and_metrics(cell):
    files = harness.cell_files(ALL, cell)
    assert files["mix"]["entry"] in ("train", "eval", "serve")
    reported = [m for m in ALL["end_to_end"] if harness.applies(m, cell)]
    assert {"setup_s"} < {m["name"] for m in reported}
    layers = [m for m in ALL["per_layer"] if harness.applies(m, cell)]
    assert layers
    for m in layers:
        # each per-layer metric's cells report the metric it moves
        assert harness.applies(E2E[m["moves"]], cell)
    assert set(files["limits"]["limits"])


@pytest.mark.parametrize("metric", [m["name"] for m in ALL["per_layer"]])
def test_reader_declares_its_metric(metric):
    m = {x["name"]: x for x in ALL["per_layer"]}[metric]
    reader = harness.load_reader(metric)
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == (
        m["unit"], m["layer"], m["moves"])
    assert reader.read({}) is None


def test_waiting_cells_are_apart_from_the_benchmark():
    """A waiting cell and its metrics are not in BENCHMARK.json, name only
    its configurations, and are written as its entries would be, each
    end-to-end metric without its bound (set when the cell is measured)."""
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    names |= {w["name"] for w in BENCH["workloads"]}
    configs = {c["name"] for c in BENCH["configs"]}
    n = len(BENCH["workloads"])
    for w in ALL["workloads"][n:]:
        assert w["name"] not in names and w["config"] in configs
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in ALL["end_to_end"][len(BENCH["end_to_end"]):]:
        assert m["name"] not in names and "bound" not in m
        assert set(m) == {"name", "unit", "better", "source", "workloads"}
    for m in ALL["per_layer"][len(BENCH["per_layer"]):]:
        assert m["name"] not in names


def test_one_layer_name_per_layer():
    by_reader = {}
    for m in BENCH["per_layer"]:
        by_reader.setdefault(m["layer"], []).append(m["name"])
    assert all("\t" not in k and "\n" not in k for k in by_reader)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_reference_numbers_match_the_composed_config(config):
    from centernet_uda_torch import config as config_lib
    from centernet_uda_torch.train import CONFIG_DIR

    c = json.loads((ROOT / {x["name"]: x for x in BENCH["configs"]}[config]
                    ["file"]).read_text())
    cfg = config_lib.compose([f"experiment={c['experiment']}",
                              *c["overrides"]], config_dir=str(CONFIG_DIR))
    ref = c["reference"]
    assert cfg.precision == c["precision"] == "float32"
    assert int(cfg.batch_size) == ref["batch_size"]
    assert int(cfg.max_detections) == ref["max_detections"]
    assert int(cfg.model.backend.params.num_classes) == ref["heads"]["hm"]
    params = cfg.optimizer.params
    assert cfg.optimizer.name == "Adam"
    assert float(params.lr) == ref["optimizer"]["lr"]
    assert float(params.weight_decay) == ref["optimizer"]["weight_decay"]
    loss = cfg.model.backend.loss.params
    for key in ("hm_weight", "wh_weight", "off_weight"):
        assert float(loss[key]) == ref["loss"][key]
    uda = cfg.model.get("uda")
    if ref["entropy_weight"] is None:
        assert not uda
    else:
        assert float(uda["EntropyMinimization"]["entropy_weight"]) == \
            ref["entropy_weight"]
