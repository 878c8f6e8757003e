"""Benchmark of the port: train and inference throughput on one card.

    python -m centernet_uda_torch.bench [--device cpu]

The counterpart of the JAX package's root ``bench.py``, with the same
knobs, stages and output. It prints ONE JSON line on stdout, last:

    {"metric": ..., "value": N, "unit": "images/sec/card",
     "vs_baseline": null, "detail": {...}}

``value`` is the combined train + infer rate of one card, 1 / (1 / train
+ 1 / infer) images a second (one train step and one inference pass per
image). ``vs_baseline`` is null: the JAX package's anchor is a TPU number
and says nothing about this card. Logs go to stderr.

Knobs (environment, the defaults of ``bench.py``):

- ``BENCH_BACKEND`` ``dla`` (DLA-34 with the DCNv2 neck), ``resnet``
  (ResNet-18), ``mobilenetv2`` (DCN and skips) or ``efficientnet`` (b0), 6
  classes each (``BACKEND_PARAMS``); ``BENCH_BATCH`` 16, ``BENCH_SIZE`` 512,
  ``BENCH_STEPS`` 20 timed steps, ``BENCH_WARMUP`` 3 (at least 2 on the
  card), ``BENCH_CHUNK`` 10;
- ``BENCH_DTYPE``: bfloat16 unless ``float32``, which is float32 with TF32
  off (``precision`` of the configs); ``BENCH_DCN`` ``auto``, ``cuda`` or
  ``xla`` (``pallas`` is read as ``cuda``, as in the configs);
- ``BENCH_GATE_{DECODE,DCN,800,PIPE}_S`` (150, 240, 480, 560): a stage that
  would start later than its gate, in seconds from the process's start, is
  skipped; ``BENCH_DECODE``, ``BENCH_DCN_OPS``, ``BENCH_800``,
  ``BENCH_PIPELINE`` (``1``; ``0`` disables the stage).

Stages, in order; a stage that gives no number writes
``<stage>_skip_reason`` into ``detail``, never a bare null:

1. ``decode``: ``decode_mean_ms_pipelined``, ``ops.decode.decode_detections``
   with k = 100 on zero heat maps at the run's batch and size;
2. ``dcn_ops`` (``dla`` only): ``dcn_fwd_ms`` and ``dcn_bwd_ms`` (forward
   and backward minus forward) of the hot DLA-34 layer, a ``DCN`` module of
   64 -> 64 channels at the run's batch and size / 4 (16 x 64 x 128 x 128 at
   the defaults), through ``ops.dcn``'s dispatch as the model runs it:
   bfloat16 launches the fused pair, float32 the offset conv and the
   float32 pair;
3. ``core``: ``train_images_per_sec`` through ``Model.step`` of the trainer
   ``train.build_trainer`` makes of ``experiment=baseline`` (the backend and
   knobs as overrides), and ``infer_images_per_sec``, the backend's forward
   plus decode (k = 100) under ``torch.inference_mode()``; one seeded
   synthetic batch (``synthetic_batch``), staged on the device first, steps
   enqueued back to back and one synchronisation at the end. On the card
   both are CUDA graphs (``utils/graphs.py``), as ``bench.py`` jits them:
   the trainer's compiled step, and forward plus decode captured as one
   graph. ``dcn_launches`` counts the DCN kernels' launches of the warm-up
   and timed calls. Then, on the card only, the cross-checks
   ``train_images_per_sec_scan`` and ``infer_images_per_sec_scan``:
   ``BENCH_CHUNK`` (10) train steps, or forward-plus-decode calls, in one
   CUDA graph, replayed ``max(steps // chunk, 2)`` times after one eager
   and one capturing call (``bench.py``'s ``lax.scan`` chunks);
   ``scan_dcn_launches`` counts their launches. On the CPU
   ``scan_skip_reason`` says why there are none;
4. ``infer_800px`` (``dla`` only): the same inference at 800 px, batch
   ``max(batch // 2, 1)`` (a graph of its own on the card);
5. ``pipeline``: ``pipeline_images_per_sec`` of
   ``tools/bench_pipeline_torch.py`` (48 images, ``MODE=process``,
   ``min(cores, 8)`` workers) in a fresh process: forking loader workers
   from a process that has started CUDA is not safe.

MFU: ``mfu_train = train_images_per_sec * F * 3 / peak`` and ``mfu_infer =
infer_images_per_sec * F / peak`` in bfloat16 runs, where ``F`` is the
port's own count of one image's forward FLOPs at the run's size
(``utils/flops.forward_flops``) and ``peak`` the card's dense bfloat16 rate
(``PEAK_BF16``, by ``torch.cuda.get_device_name()``); otherwise null with
``mfu_skip_reason``.

Devices: ``main()`` runs on the card and raises without one; only
``device="cpu"`` (``--device cpu``) runs on the CPU, where the DCN layers
take the exact op or the kernels' plain twins. A card run has no
fallback: a stage that fails there (a kernel that does not build or
launch) raises; on the CPU a failing stage writes its error as the skip
reason, as ``bench.py`` does.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from centernet_uda_torch import resolve_device
from centernet_uda_torch.config import compose
from centernet_uda_torch.ops import dcn_cuda
from centernet_uda_torch.ops.dcn import DCN, DCN_IMPLS
from centernet_uda_torch.ops.decode import decode_detections
from centernet_uda_torch.train import CONFIG_DIR, build_trainer
from centernet_uda_torch.utils.flops import forward_flops
from centernet_uda_torch.utils.graphs import StepGraphs

log = logging.getLogger("bench")

_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]

# the backends and their parameters (those of bench.py), 6 classes each
BACKEND_PARAMS = {
    "dla": {"num_classes": 6},
    "resnet": {"num_layers": 18, "num_classes": 6, "pretrained": False},
    "mobilenetv2": {"num_classes": 6, "pretrained": False, "use_dcn": True,
                    "use_skip": True},
    "efficientnet": {"variant": "b0", "num_classes": 6, "pretrained": False},
}
# dense bfloat16 tensor-core peak, FLOP/s, by torch.cuda.get_device_name()
PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989.4e12}
# the hot DLA-34 DCN layer's channels (64 -> 64 at a quarter of the input)
HOT_CHANNELS = 64
EVAL_SIZE = 800
# the host pipeline's run (bench.py:_pipeline_rate)
PIPELINE_IMAGES = 48


def _elapsed() -> float:
    return time.perf_counter() - _START


def _switched_off(knob: str) -> str | None:
    """The skip reason of a stage whose switch is ``0``."""
    return "disabled via env" if os.environ.get(knob, "1") != "1" else None


class _Stages:
    """Per-stage results and skip reasons, all landing in the final JSON;
    ``strict`` (a card run) lets a failing stage raise."""

    def __init__(self, strict: bool):
        self.strict = strict
        self.detail = {}
        self.seconds = {}

    def run(self, name: str, skip: str | None, gate_s: float, fn) -> None:
        """Run one optional stage unless ``skip`` gives a reason not to.
        ``fn`` returns a dict merged into ``detail``; a skip writes
        ``<name>_skip_reason`` instead."""
        if skip:
            self.detail[f"{name}_skip_reason"] = skip
            return
        at = _elapsed()
        if at >= gate_s:
            self.detail[f"{name}_skip_reason"] = (
                f"budget: stage start at {at:.0f}s >= gate {gate_s:.0f}s")
            return
        t0 = time.perf_counter()
        try:
            self.detail.update(fn())
        except Exception as exc:
            if self.strict:
                raise
            reason = f"error: {type(exc).__name__}: {exc}"
            self.detail[f"{name}_skip_reason"] = reason[:300]
            log.warning("%s stage skipped: %s", name, reason)
        finally:
            self.seconds[name] = round(time.perf_counter() - t0, 1)


def synthetic_batch(batch_size: int, input_size: int):
    """One seeded training batch of 6 classes and 10 objects an image: a
    copy of the JAX package's ``__graft_entry__._tiny_batch`` (the same
    numbers from the same seed) in the port's layout (NCHW images and heat
    maps)."""
    num_classes, k = 6, 10
    rng = np.random.RandomState(0)
    out_size = input_size // 4
    batch = {
        "input": rng.randn(batch_size, input_size, input_size, 3)
        .astype(np.float32).transpose(0, 3, 1, 2).copy(),
        "hm": np.zeros((batch_size, num_classes, out_size, out_size),
                       np.float32),
        "wh": rng.rand(batch_size, k, 2).astype(np.float32),
        "reg": rng.rand(batch_size, k, 2).astype(np.float32),
        "ind": rng.randint(0, out_size * out_size, (batch_size, k))
        .astype(np.int64),
        "reg_mask": (rng.rand(batch_size, k) > 0.5).astype(np.uint8),
    }
    batch["hm"][:, 0, out_size // 2, out_size // 2] = 1.0
    return batch


def pipeline_rate(timeout_s: float, **knobs) -> float:
    """``pipeline_images_per_sec`` of ``tools/bench_pipeline_torch.py`` run
    in a fresh process with ``IMAGES=48 MODE=process WORKERS=min(cores, 8)``
    (``knobs`` override these and set others, e.g. ``SIZE``)."""
    env = {**os.environ, "IMAGES": str(PIPELINE_IMAGES), "MODE": "process",
           "WORKERS": str(min(os.cpu_count() or 1, 8))}
    env.update({k: str(v) for k, v in knobs.items()})
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "bench_pipeline_torch.py")],
        env=env, capture_output=True, text=True, timeout=timeout_s)
    if out.returncode != 0:
        raise RuntimeError(f"bench_pipeline_torch.py exited "
                           f"{out.returncode}: {out.stderr[-500:]}")
    line = out.stdout.strip().splitlines()[-1]
    return float(json.loads(line)["pipeline_images_per_sec"])


def nvidia_smi() -> str:
    """The card's ``name, power.limit`` as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _timed(fn, n: int, sync) -> float:
    """Seconds of ``n`` calls of ``fn`` enqueued back to back, ended by one
    synchronisation."""
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync()
    return time.perf_counter() - t0


def _dcn_ops(dtype, impl, batch, size, steps, device, sync):
    """Forward and backward ms of the hot DLA-34 DCN layer: a seeded
    ``DCN(64, 64)`` whose offset conv gives offsets and mask logits of
    about unit spread, on x of (batch, 64, size / 4, size / 4)."""
    gen = torch.Generator().manual_seed(0)
    dcn = DCN(HOT_CHANNELS, HOT_CHANNELS, impl=impl, dtype=dtype)
    dcn.reset_parameters(gen)
    om = dcn.conv_offset_mask
    with torch.no_grad():
        # a sum of 64 * 9 unit terms: unit spread at weights of 1 / 24
        om.weight.copy_(torch.randn(om.weight.shape, generator=gen) / 24.0)
    dcn = dcn.to(device)
    hw = size // 4
    x = torch.randn(batch, HOT_CHANNELS, hw, hw, generator=gen).to(
        device, dtype).requires_grad_(True)
    params = [x, *dcn.parameters()]

    def fwd():
        with torch.no_grad():
            return dcn(x).float().sum()

    def fwd_bwd():
        return torch.autograd.grad(dcn(x).float().sum(), params)

    fwd()
    fwd_bwd()
    fwd_s = _timed(fwd, steps, sync)
    both_s = _timed(fwd_bwd, steps, sync)
    fwd_ms = fwd_s / steps * 1e3
    return {"dcn_fwd_ms": round(fwd_ms, 3),
            "dcn_bwd_ms": round(max(both_s / steps * 1e3 - fwd_ms, 0.0), 3)}


def _forward_decode(net, calls: int = 1):
    """``calls`` forwards plus decode (k = 100) of ``inputs["input"]``, as a
    serving call runs; returns the last call's detections."""

    def run(inputs):
        with torch.inference_mode():
            for _ in range(calls):
                out = net(inputs["input"])
                dets = decode_detections(out["hm"], out["wh"], out.get("reg"),
                                         k=100, apply_sigmoid=True)
            return dets

    return run


def _infer_fn(net, x, graphs=None, calls: int = 1):
    """A call of ``_forward_decode`` on ``x``: a replayed graph of
    ``graphs`` (a ``StepGraphs``) where given, else eager."""
    fn = _forward_decode(net, calls)
    if graphs is None:
        return lambda: fn({"input": x})
    name = f"infer{calls}"
    return lambda: graphs(name, fn, {"input": x})


def _scan_rates(trainer, net, data, infer_graphs, steps, sync):
    """``train_images_per_sec_scan`` and ``infer_images_per_sec_scan``:
    ``BENCH_CHUNK`` train steps (``trainer.train_step`` on the device batch)
    or forward-plus-decode calls in one CUDA graph, after one eager and one
    capturing call, timed over ``max(steps // chunk, 2)`` replays. The
    trainer leaves eval mode for the train chunk and returns to it."""
    chunk = int(os.environ.get("BENCH_CHUNK", 10))
    n_chunks = max(steps // chunk, 2)
    batch = data["input"].shape[0]

    def train_chunk(inputs):
        for _ in range(chunk):
            stats = trainer.train_step(inputs)
        return stats["total_loss"]

    def train():
        return trainer.step_graphs("train_scan", train_chunk, data,
                                   trainer.train_generators)

    for _ in range(2):
        train()
    train_s = _timed(train, n_chunks, sync)
    net.eval()
    infer = _infer_fn(net, data["input"], infer_graphs, calls=chunk)
    for _ in range(2):
        infer()
    infer_s = _timed(infer, n_chunks, sync)
    return {"train_images_per_sec_scan": round(
                batch * chunk * n_chunks / train_s, 2),
            "infer_images_per_sec_scan": round(
                batch * chunk * n_chunks / infer_s, 2),
            "scan_chunk": chunk, "scan_chunks": n_chunks}


def main(argv=None, device: str = "cuda") -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=device,
                        help="cuda (the default; raises without a card) or "
                             "cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="# %(name)s: %(message)s")
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    env = os.environ
    backend_name = env.get("BENCH_BACKEND", "dla")
    if backend_name not in BACKEND_PARAMS:
        raise SystemExit(f"unknown BENCH_BACKEND {backend_name!r}")
    batch_size = int(env.get("BENCH_BATCH", 16))
    input_size = int(env.get("BENCH_SIZE", 512))
    steps = int(env.get("BENCH_STEPS", 20))
    warmup = int(env.get("BENCH_WARMUP", 3))
    if cuda:
        # the first call of a graphed step runs eagerly, the second captures
        warmup = max(warmup, 2)
    gate_decode = float(env.get("BENCH_GATE_DECODE_S", "150"))
    gate_dcn = float(env.get("BENCH_GATE_DCN_S", "240"))
    gate_800 = float(env.get("BENCH_GATE_800_S", "480"))
    gate_pipe = float(env.get("BENCH_GATE_PIPE_S", "560"))
    # "pallas" runs the kernel path, as in the configs
    dcn_impl = env.get("BENCH_DCN", "auto")
    if dcn_impl not in DCN_IMPLS:
        raise SystemExit(f"BENCH_DCN must be one of {DCN_IMPLS}, got "
                         f"{dcn_impl!r}")
    float32 = env.get("BENCH_DTYPE") == "float32"
    dtype = torch.float32 if float32 else torch.bfloat16
    # float32 means float32 (train.build_trainer sets the same)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        t0 = time.perf_counter()
        dcn_cuda.build_kernels()
        log.info("kernels built in %.1f s", time.perf_counter() - t0)

    stages = _Stages(strict=cuda)

    # --- 1: decode latency, pipelined mean over many calls -------------
    def stage_decode():
        hw = input_size // 4
        hm = torch.zeros(batch_size, 6, hw, hw, device=device)
        wh = torch.ones(batch_size, 2, hw, hw, device=device)
        reg = torch.zeros(batch_size, 2, hw, hw, device=device)

        def decode():
            return decode_detections(hm, wh, reg, k=100, apply_sigmoid=True)

        decode()
        n = max(steps * 5, 50)
        return {"decode_mean_ms_pipelined": round(
            _timed(decode, n, sync) / n * 1e3, 3)}

    stages.run("decode", _switched_off("BENCH_DECODE"), gate_decode,
               stage_decode)

    # --- 2: the hot DCN layer, forward and backward -----------------------
    dla_only = None if backend_name == "dla" else "DLA-34 only"
    stages.run("dcn_ops", dla_only or _switched_off("BENCH_DCN_OPS"),
               gate_dcn, lambda: _dcn_ops(dtype, dcn_impl, batch_size,
                                          input_size, steps, device, sync))

    # --- 3: the core measurement: train steps, then forward + decode -----
    t_core = time.perf_counter()
    overrides = [f"model.backend.name={backend_name}"] + [
        f"model.backend.params.{k}={v}"
        for k, v in BACKEND_PARAMS[backend_name].items()]
    cfg = compose(["experiment=baseline", *overrides,
                   f"precision={'float32' if float32 else 'bfloat16'}",
                   f"dcn_impl={dcn_impl}", f"batch_size={batch_size}",
                   f"datasets.training.params.input_size="
                   f"[{input_size},{input_size}]"],
                  config_dir=str(CONFIG_DIR))
    trainer = build_trainer(cfg, device=device)
    trainer.init_done()
    infer_graphs = StepGraphs(device) if cuda else None
    # staged on the device first: the device's step rate, not the copies
    data = {k: torch.as_tensor(v).to(device)
            for k, v in synthetic_batch(batch_size, input_size).items()}
    dcn_cuda.reset_launches()

    def train_step():
        return trainer.step(data, is_training=True)

    for _ in range(warmup):
        train_step()
    train_s = _timed(train_step, steps, sync)
    train_ips = batch_size * steps / train_s

    net = trainer.backend.module.eval()
    infer = _infer_fn(net, data["input"], infer_graphs)
    for _ in range(warmup):
        infer()
    infer_ips = batch_size * steps / _timed(infer, steps, sync)
    launches = dict(dcn_cuda.LAUNCHES)
    scan = {"scan_skip_reason": (
        "no card: the *_scan rates are CUDA graphs of BENCH_CHUNK steps")}
    if cuda:
        dcn_cuda.reset_launches()
        scan = _scan_rates(trainer, net, data, infer_graphs, steps, sync)
        scan["scan_dcn_launches"] = dict(dcn_cuda.LAUNCHES)
    stages.seconds["core"] = round(time.perf_counter() - t_core, 1)

    # --- 4: 800 px eval-resolution inference ------------------------------
    def stage_800():
        b800 = max(batch_size // 2, 1)
        x800 = torch.from_numpy(
            np.random.RandomState(0).randn(b800, EVAL_SIZE, EVAL_SIZE, 3)
            .astype(np.float32).transpose(0, 3, 1, 2).copy()).to(device)
        infer800 = _infer_fn(net, x800, infer_graphs)
        for _ in range(2 if cuda else 1):
            infer800()
        return {"infer_800px_images_per_sec": round(
            b800 * steps / _timed(infer800, steps, sync), 2)}

    stages.run("infer_800px", dla_only or _switched_off("BENCH_800"),
               gate_800, stage_800)

    # --- 5: the host input pipeline, in a fresh process -------------------
    stages.run("pipeline", _switched_off("BENCH_PIPELINE"), gate_pipe,
               lambda: {"pipeline_images_per_sec": round(pipeline_rate(
                   max(gate_pipe + 120.0 - _elapsed(), 30.0)), 2)})

    # --- the one stdout JSON line ------------------------------------------
    combined = 1.0 / (1.0 / train_ips + 1.0 / infer_ips)
    flops = forward_flops(backend_name, input_size,
                          **BACKEND_PARAMS[backend_name])
    card = torch.cuda.get_device_name(device) if cuda else None
    peak = PEAK_BF16.get(card)
    mfu_train = mfu_infer = None
    detail = {}
    if not cuda:
        detail["mfu_skip_reason"] = "no card: MFU is against a card's peak"
    elif float32:
        detail["mfu_skip_reason"] = ("float32 run: MFU is against the dense "
                                     "bfloat16 peak")
    elif peak is None:
        detail["mfu_skip_reason"] = (f"no dense bfloat16 peak known for "
                                     f"{card!r}")
    else:
        mfu_train = round(train_ips * flops * 3 / peak, 4)
        mfu_infer = round(infer_ips * flops / peak, 4)
    detail.update({
        "train_images_per_sec": round(train_ips, 2),
        "infer_images_per_sec": round(infer_ips, 2),
        "train_ms_per_step": round(train_s / steps * 1e3, 3),
        **scan,
        "mfu_train": mfu_train,
        "mfu_infer": mfu_infer,
        "model_gflops_per_image": round(flops / 1e9, 4),
        "dtype": "float32" if float32 else "bfloat16",
        "dcn_impl": dcn_impl,
        "dcn_launches": launches,
        "batch_size": batch_size,
        "steps": steps,
        # the run uses one card; value is that card's rate
        "devices": 1,
        "visible_devices": torch.cuda.device_count() if cuda else 0,
        "host_cores": os.cpu_count() or 1,
        "platform": "gpu" if cuda else "cpu",
        "card": card,
        "nvidia_smi": nvidia_smi() if cuda else None,
    })
    detail.update(stages.detail)
    detail["stage_seconds"] = stages.seconds
    where = f"one {card}" if cuda else "the CPU"
    result = {
        "metric": (f"{backend_name} {input_size}px train+infer throughput "
                   f"on {where}, {detail['dtype']} (vs_baseline null: the "
                   "JAX package's anchor is a TPU number)"),
        "value": round(combined, 2),
        "unit": "images/sec/card",
        "vs_baseline": None,
        "detail": detail,
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
