"""The port's bench (``python -m centernet_uda_torch.bench``) as a CPU smoke.

``bench.main(device="cpu")`` runs in a subprocess at 64 px, batch 2, 2
steps after 1 warm-up step, for DLA-34 and ResNet-18: its last stdout line
is one JSON object of ``bench.py``'s shape, every stage gives its number or
its ``<stage>_skip_reason``, MFU is null with a reason (no card), and
neither JAX nor the JAX package was imported. The pipeline stage runs on
its own at 16 images of 64 px in process mode with 4 workers. Without a
card and without ``device="cpu"`` the bench raises. The ``*_scan`` stage,
CUDA graphs on a card, runs through a stand-in graph on the CPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "centernet_uda_tpu")
KNOBS = {"BENCH_SIZE": "64", "BENCH_BATCH": "2", "BENCH_STEPS": "2",
         "BENCH_WARMUP": "1", "BENCH_800": "0", "BENCH_PIPELINE": "0",
         "OMP_NUM_THREADS": "2"}
SCRIPT = "\n".join([
    "import sys, torch",
    "torch.set_num_threads(2)",
    "from centernet_uda_torch import bench",
    "rc = bench.main([], device='cpu')",
    "bad = [m for m in sys.modules if m.split('.')[0] in "
    f"{FORBIDDEN!r}]",
    "sys.exit(3 if bad or rc else 0)",
])
# each stage: the numbers it gives
STAGE_KEYS = {
    "decode": ("decode_mean_ms_pipelined",),
    "dcn_ops": ("dcn_fwd_ms", "dcn_bwd_ms"),
    "infer_800px": ("infer_800px_images_per_sec",),
    "pipeline": ("pipeline_images_per_sec",),
    "mfu": ("mfu_train", "mfu_infer"),
}


def run_bench(**env):
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         env={**os.environ, **KNOBS, **env},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("backend", ["dla", "resnet"])
def test_bench_line_on_the_cpu(backend):
    res = run_bench(BENCH_BACKEND=backend)
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert res["vs_baseline"] is None
    assert res["unit"] == "images/sec/card"
    d = res["detail"]
    assert d["platform"] == "cpu" and d["batch_size"] == 2
    train, infer = d["train_images_per_sec"], d["infer_images_per_sec"]
    assert train > 0 and infer > 0
    assert res["value"] == pytest.approx(1 / (1 / train + 1 / infer),
                                         abs=0.01)
    for stage, keys in STAGE_KEYS.items():
        reason = d.get(f"{stage}_skip_reason")
        if reason is None:
            # 2 steps on a shared CPU: a backward-minus-forward may come
            # out at its floor of 0
            assert all(isinstance(d[k], float) and d[k] >= 0
                       for k in keys), (stage, d)
        else:
            assert isinstance(reason, str) and reason, stage
            assert all(d.get(k) is None for k in keys), stage
    # DLA-34 runs every stage but the switched-off ones; the DCN stages are
    # DLA-34's alone
    assert d["pipeline_skip_reason"] == "disabled via env"
    assert d["infer_800px_skip_reason"] == (
        "disabled via env" if backend == "dla" else "DLA-34 only")
    assert ("dcn_ops_skip_reason" in d) == (backend != "dla")
    assert "decode_skip_reason" not in d
    assert d["mfu_train"] is None and d["mfu_skip_reason"].startswith(
        "no card")
    # the *_scan rates are CUDA graphs: on the CPU a reason, no number
    assert d["scan_skip_reason"].startswith("no card")
    assert "train_images_per_sec_scan" not in d
    assert d["model_gflops_per_image"] > 0
    # no kernel launches on the CPU: the DCN layers run the exact op
    assert not any(d["dcn_launches"].values())


def test_scan_rates_fill_the_jax_benchs_keys(monkeypatch):
    """The ``*_scan`` stage (a card run's: CUDA graphs of ``BENCH_CHUNK``
    steps) through a stand-in graph on the CPU, on a narrow DLA at 64 px:
    it fills ``train_images_per_sec_scan`` and
    ``infer_images_per_sec_scan``, the names of root ``bench.py``'s line,
    with rates."""
    import torch

    from centernet_uda_torch import bench
    from centernet_uda_torch.config import compose
    from centernet_uda_torch.train import build_trainer
    from centernet_uda_torch.utils.graphs import StepGraphs
    from tests.test_torch_step_graphs import StandInGraph, stand_in_graphs

    torch.set_num_threads(2)
    monkeypatch.setenv("BENCH_CHUNK", "2")
    cfg = compose(["experiment=baseline", "dcn_impl=xla", "batch_size=2",
                   "model.backend.params.num_classes=6",
                   "model.backend.params.levels=[1,1,1,1,1,1]",
                   "model.backend.params.channels=[4,8,8,16,16,32]",
                   "model.backend.params.head_conv=8"],
                  config_dir=str(ROOT / "configs"))
    trainer = build_trainer(cfg, device="cpu")
    trainer.init_done()
    graphs = stand_in_graphs(trainer)
    data = {k: torch.as_tensor(v)
            for k, v in bench.synthetic_batch(2, 64).items()}
    net = trainer.backend.module
    scan = bench._scan_rates(trainer, net, data,
                             StepGraphs("cpu", StandInGraph, counters={}),
                             2, lambda: None)
    keys = ("train_images_per_sec_scan", "infer_images_per_sec_scan")
    assert set(scan) == {*keys, "scan_chunk", "scan_chunks"}
    assert all(scan[k] > 0 for k in keys)
    assert (scan["scan_chunk"], scan["scan_chunks"]) == (2, 2)
    assert graphs.calls == {"eager": 1, "captures": 1, "replays": 3}
    jax_bench = (ROOT / "bench.py").read_text()
    assert all(f'"{k}"' in jax_bench for k in keys)
    assert not net.training


def test_pipeline_stage_in_process_mode():
    """The pipeline stage's subprocess, small: 16 JPEGs of 64 px, batch 4,
    4 worker processes, 1 s a loader run; it must finish in its time."""
    from centernet_uda_torch.bench import pipeline_rate

    rate = pipeline_rate(120.0, IMAGES=16, SIZE=64, BATCH=4, WORKERS=4,
                         SECONDS=1)
    assert rate > 0


def test_bench_needs_a_card_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "-m", "centernet_uda_torch.bench"], cwd=ROOT,
        env={**os.environ, **KNOBS}, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not out.stdout.strip()
