"""Smoke run of the PyTorch/CUDA port (``centernet_uda_torch``) on one card.

    python3 chip_smoke.py [--json PATH] [--profile] [--parent DIR] [--seed N]

Run from the root of a checkout on a machine with an NVIDIA H100. Phases:

1. probe: the card, its power limit, torch, CUDA, nvcc, the image and
   logging libraries of the host; the card must be compute capability 9.0;
2. build: compiles the seven DCN kernel sources from
   ``centernet_uda_torch/csrc/`` (one ``nvcc`` each, in parallel) and prints
   the compiler's register / shared-memory report, then the host library
   (``csrc/host_encoder.cpp``, ``g++``) and loads it;
3. kernels: each kernel against its plain PyTorch twin on the same inputs
   (atol 5e-2 * max(1, max|twin|), rtol 5e-2: the bound of the Pallas
   kernels' own tests; max |dy| to 1e-5 relative), timed beside its twin
   and a cuDNN yardstick:
   - the float32 pair and the fused bfloat16 pair at every DCN shape of
     DLA-34's 512 px train path (batch 16, and batch 8, the UDA configs'
     batch) and 800 px eval path (batch 4), and the fused pair at
     MobileNetV2's 256 -> 256 shapes (@32 and @64, batch 32); one call of
     the fused pair at the largest DLA-34 shape is
     profiled for its launches (1 forward, 4 backward) and each launch's
     device time, and so is one call of the float32 pair there (1 forward,
     2 backward);
   - the "select" pair, in float32 and in bfloat16, at MobileNetV2's
     1280 -> 256 DCN shapes (512 px train, batch 32: 16 x 16; 800 px eval,
     batch 4: 25 x 25) and at 2 x 300 x 300 x 64; one bfloat16 call of the
     pair at the train shape is profiled (1 forward, 2 backward launches);
   - the wide forward (dx clamped too), in both dtypes, at 2 x 300 x 300 x
     64 and at DLA-34's 64 -> 64 @272, batch 4 (the 1088 px eval);
4. DLA-34 train and eval: ``experiment=baseline`` (full width, ``dcn_impl:
   auto``) takes 4 steps at 512 px, batch 16, on one seeded synthetic
   batch, then one eval step at 800 px plus decode, first at float32 and
   then at ``precision=bfloat16``; losses and detections finite, no layer
   at the offset clamp, and each step launches exactly its precision's
   kernels (16 layers);
5. MobileNetV2 train and eval: ``experiment=baseline_mobilenet_v2`` with
   ``use_dcn=true`` (full width, skips, batch 32) the same way at each
   precision: a train step launches ``dcn_sel_fwd``/``dcn_sel_bwd`` once
   (the 1280-channel layer) and the lanes kernels twice (float32:
   ``dcn_fwd``/``dcn_bwd``; bfloat16: the fused pair), an eval the forward
   kernels only;
6. forced "lanes": DLA-34 at float32 evaluates 1088 px, batch 4, under
   ``set_kernel_version("lanes")``: the layers at W = 272 launch
   ``dcn_wide_fwd`` and the rest ``dcn_fwd``;
7. CLI on data: writes a COCO set of 32 training and 16 validation PPM
   images of 640 x 480 (6 classes, 5-29 boxes each, from ``--seed``)
   under ``build/cli/`` and runs the port's ``train.main`` for
   ``experiment=baseline`` at full width: 2 epochs at float32 (512 px batch
   16 with the defaults' augmentation, 800 px validation batch 16 with the
   COCO evaluator, 4 loader threads), a resume from its ``model_last.ckpt``
   to epoch 3 (which must restore the optimizer at epoch 2 and run epoch 3
   only), then 1 epoch at bfloat16; the float32 run's TensorBoard event
   file must hold the ``MSCOCO_*`` scalars; the same 2 float32 epochs again
   without the host library (``CENTERNET_DISABLE_NATIVE``), each epoch's
   loader-wait share printed beside the library's, each eval phase's
   seconds beside its detection images' and its evaluator's, and the
   evaluator alone, library and numpy in turns on seeded detections; 1
   epoch from
   ``model_last.ckpt`` with every key under DataParallel's ``module.``
   prefix as ``pretrained`` (every weight restored); then
   ``experiment=baseline_mobilenet_v2`` with ``use_dcn=true`` (batch 32: a
   train step launches ``dcn_sel_fwd``/``dcn_sel_bwd`` once and the lanes
   pair twice) and ``experiment=baseline_resnet18`` (batch 16, no DCN
   layer), 1 float32 epoch each; then
   ``experiment=adversarial_entropy_minimization`` (batch 8, the validation
   images as the target domain of both phases) for 1 epoch at float32,
   which writes ``discriminator.ckpt`` beside ``model_last.ckpt``, and a
   resume to epoch 2 that restores both optimizers; then
   ``experiment=coco_merged`` (EfficientNet-b3 with skips, rotated boxes
   and 5 keypoints, ``coco_merger`` over two source folders of 16 images
   each, with rotated boxes and keypoints in their annotations and the
   experiment's augmentation, batch 8 at 512 px, validation at 800 px with
   the rotated evaluator) for 1 epoch at float32. Each eval phase writes
   its detection images to TensorBoard, all 16 in the two float32 runs
   with and without the library (timed side by side), ``CLI_VISUALIZATIONS``
   in the others. Each train step must
   launch the 16 layers' forward and backward kernels of its precision
   (twice for ADVENT: source and target; none for EfficientNet), each eval
   step the forwards; losses and the COCO means finite; the checkpoints
   written; every run but the one without it must have called the host
   library's target encoder (not for rotated boxes, which keep numpy's),
   normalisation and COCO matcher (``native.CALLS``). The JAX package's
   checkpoints are not read here (this host has no JAX to write one; the
   CPU tests hold that path), and the phase says so.
   It prints each epoch's train time and loader-wait share and the eval
   time with the evaluator; with ``--profile`` the float32 run also traces
   its first two steps (``profile_steps``) and prints the device time of
   each kind of memory copy per step;
8. UDA trainers: ``experiment=entropy_minimization``,
   ``max_squares_minimization``, ``fda`` and
   ``adversarial_entropy_minimization`` at full width and their own batch
   (8, 16, 8, 8), on a seeded synthetic batch with a target domain of
   another mean and contrast, each take 3 train steps at 512 px and one
   eval step at 800 px with decode, at float32, and entropy minimization
   and ADVENT at bfloat16 too. Each train step must launch 2 x 16 forward and 2 x 16
   backward kernels of its precision, each eval step 2 x 16 forwards;
   losses, UDA stats and detections finite; ADVENT's discriminator must
   move in every step; FDA's mix on the card must agree with the CPU's
   within 1e-4 of the image scale. It prints steps 2-3 and the peak
   memory of each;
9. backbones, rotated boxes, keypoints: on seeded synthetic batches with
   rotated boxes and keypoints where the config has them, each run takes
   3 train steps at 512 px and one eval step at 800 px with decode, with
   its step times, peak memory and DCN launches per step:
   a. ``experiment=rotated`` (ResNet-101, rotated boxes, the periodic angle
      loss, batch 16) at float32 and bfloat16: 0 DCN launches;
   b. ``experiment=baseline_resnet18`` (batch 16) and ``baseline_resnet50``
      (batch 8) at float32: 0 launches;
   c. ``experiment=keypoints`` with ``gpu=null`` (EfficientNet-b0 with
      skips, 5 keypoints, entropy minimization with a target batch, batch
      16) at float32 and bfloat16: 0 launches (its two-device data
      parallelism is cut); its train steps must replay their graph (the
      stochastic-depth generator registered with it), and the graph calls
      are printed;
   d. DLA-34 ``experiment=baseline`` with ``rotated_boxes=true``,
      ``num_keypoints=5`` and ``coco_merged``'s loss params (periodic,
      ``kp_weight`` 2.0, ``kp_indices``, ``kp_distance_weight`` 10) at
      float32 and bfloat16: 16 launches of the precision's forward and
      backward kernels per train step, 16 forwards per eval; the clamp
      monitor printed;
   e. the same DLA-34 at float32 with ``freeze_base=true``: launches as in
      d; after the steps every trunk parameter is bitwise unchanged and
      every head parameter has moved.
   The new backbones' f32 heads on the card are held against the same
   module on the CPU, run there in float64 (same weights and input,
   train-mode BatchNorm, TF32 off), within 1e-3 of each head's scale;
   DLA-34's against the exact DCN op as in phase 4;
10. serving export and data parallelism:
   a. the export CLI (``centernet_uda_torch.export.main``) writes DLA-34's
      artifacts from phase 7's float32 checkpoint: 512 px batch 1 with
      decode (``.pt2`` and ``.opt.pt2``) and 800 px batch 4 without
      (``-wd``, ``.pt2``); each is reloaded with ``load_artifact`` here and
      in a fresh process that imports the port alone (no JAX), and every
      call on the card must launch exactly the 16 ``dcn_fwd`` of the DCN
      layers and give the eager serving module's outputs (raw heads within
      1e-5 of their scale, the sorted top-k scores within 1e-5, and each
      top-k row clear of the cut with a partner row of the same class, a
      score within that bound and the same box (where no partner has it,
      the eager heads' box at a pixel the pool may keep, of the row's
      class and score, within the max-pool window of the pixel that
      decodes a partner: a max-pool near-tie may keep either); or within
      4 times the
      eager module's own spread over 4 more calls, where that is larger:
      the DCN forward is not bitwise repeatable); ms per call, eager and
      artifact;
   b. MobileNetV2 with ``use_dcn=true`` (seeded init) exported at 512 px
      the same way: 1 ``dcn_sel_fwd`` and 2 ``dcn_fwd`` per call;
   c. DLA-34 at float32 and bfloat16 takes 3 steps on one batch as a plain
      trainer and as the trainer of a one-rank NCCL group: 16 + 16
      launches of the precision a step, the first step's losses equal
      within 1e-5 of the largest (or 4 times the range of 4 plain
      trainers' first steps, where that is larger), step times beside
      each other; the rank's train steps are graphed (their all-reduces
      captured) and must replay, and its graph calls are printed; then
      ``main()`` with ``mesh.data=1`` (one NCCL rank that ``main()`` joins
      itself) for an epoch of phase 7's set at each precision, whose
      training phase must replay its graph (each phase's graph calls
      printed);
   d. DLA-34 at float32 with ``bn_sync`` 2 and 4: 3 steps and an eval,
      launches as in phase 4, losses finite;
   e. ``experiment=adversarial_entropy_minimization_dla`` as shipped
      (``gpu: [0, 1]``) through ``main()`` on phase 7's set: it must warn
      that one device is visible and train an epoch on it;
   f. ``DCNPooling`` at the deformable R-FCN's shape (81 classes, 7 x 7,
      128 RoIs on a 2 x 3969 x 32 x 32 map) on the card against the CPU:
      output and gradients within 1e-4 of their scale;
11. host pipeline: ``tools/bench_pipeline_torch.py`` on 64 seeded JPEGs at
   512 px, batch 16, the training augmentation, 4 and then 8 loader
   threads, with the host library and with numpy: each stage's ms a sample
   (decode, augment, normalise, encode, other, collate, pin) and the
   loader's images a second; then, in a fresh process, a process loader of
   ``STOP_WORKERS`` workers on those JPEGs with the augmentation is left
   after one batch, ``STOP_TIMES`` times, and each time must give control
   back within ``STOP_LIMIT_S`` (ROADMAP C3);
12. bench: ``python -m centernet_uda_torch.bench`` in a fresh process, once
   at bfloat16 with every stage (``BENCH_STEPS=10``) and once at float32
   without the 800 px and pipeline stages: every stage must give its number
   (no ``_skip_reason`` but the switched-off stages' and, at float32,
   MFU's), the scan cross-checks included (``*_scan``: 10 steps or calls in
   one CUDA graph), ``mfu_train`` must lie in (0, 1), each train rate within
   ``BENCH_RATE_TOL`` of the batch over the median replayed train step
   (the third and fourth) of phase 4 at its precision, and its
   ``dcn_launches`` and ``scan_dcn_launches``
   exactly its precision's kernels, 16 a forward for every warm-up, timed
   and inference call; both lines are printed;
13. compiled steps (``utils/graphs.py``): DLA-34 at float32 and bfloat16
   (batch 16), each also as the trainers of a one-rank NCCL group, the
   four UDA trainers at bfloat16 (batch 8) and ``experiment=keypoints``
   (EfficientNet-b0, its stochastic depth on) at bfloat16 (batch 16) at
   512 px, each trained by two eager trainers (``graphs=False``) and one
   graphed trainer from one seed on one batch (``GRAPH_RUNS``): 3 steps, a
   MultiStepLR milestone (``epoch_end``), 2 steps; the graphed losses and
   parameters within ``GRAPH_SPREAD`` times the eager runs' spread, each
   step's launches exact, the milestone dropping the graphs and the step
   captured after it moving the parameters at the new rate; the median
   step ms, busy share (torch.profiler over 2 steps, whose kernel names
   hold the DCN kernels inside graph replays too) and peak memory eager
   and graphed; for DLA-34 at float32 the batch-1 512 px serving call
   (forward plus decode) eager and graphed, then the degrade: after
   ``maybe_degrade_dcn(PALLAS_MAX_SHIFT)`` two steps capture anew on the
   exact op and launch no kernel; for the one-rank runs two eval steps of
   the graphed trainer, the second captured (its loss normalizers'
   all-reduces inside) and replayed; for ``keypoints`` every step's
   stochastic-depth masks, graphed against eager at the same step count,
   bit for bit.

Before each model trains, its heads on the kernel path are held against the
exact DCN op on the same weights and a small input. Every phase drives the
entry points a user calls (``build_trainer``, ``Model.step``,
``get_detections``) with the launch counters set to 0 just before and read
just after. Their steps are the default ones, CUDA graphs on the card: a
signature's first call runs eagerly, the second captures, later ones
replay, and the launch counts per step are exact either way. The last lines are a ``{"kernels": [...]}`` JSON line (one
entry per kernel source, launches summed over phases 4-10, 12 and 13), the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": {...}}``.
Any failure exits non-zero. ``--json PATH`` also writes every measurement
to PATH; ``--profile`` adds a torch.profiler breakdown by kernel of two
more train steps of each model (and UDA trainer) at each precision;
``--parent DIR`` (a
checkout of another commit, e.g. ``git archive`` of the parent unpacked
under ``build/``) builds that checkout's kernels too and times, in the same
run and in turns (its, this, this, its), its fused pair at every fused
shape, its float32 and select pairs and its wide forward at every shape of
theirs.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

TRAIN_SIZE, TRAIN_BATCH, TRAIN_STEPS = 512, 16, 4
EVAL_SIZE, EVAL_BATCH_KERNELS = 800, 4
MNV2_TRAIN_BATCH = 32  # experiment=baseline_mobilenet_v2's batch_size
# the forced-"lanes" eval: DLA-34 at 1088 px puts its stride-4 DCN layers
# at W = 272, past the lanes kernels' native 256
WIDE_SIZE, WIDE_BATCH = 1088, 4
# ROADMAP B5's W > 256 shape for the select pair and the wide forward
SHAPE_300 = (2, 64, 64, 300, 300)  # (batch, cin, cout, h, w)
# the CLI phase's dataset: 640 x 480 is neither input size, so the loader's
# Resize does real work (to 512 px for training, 800 px for validation)
CLI_TRAIN_IMAGES, CLI_VAL_IMAGES, CLI_IMAGE_WH = 32, 16, (640, 480)
CLI_DIR = ROOT / "build" / "cli"
# the UDA trainers (phase 8), each at its experiment's own batch: 8 for
# three of them (configs/experiment/*.yaml), the defaults' 16 for max
# squares; 3 train steps, then one eval step
UDA_EXPERIMENTS = ("entropy_minimization", "max_squares_minimization", "fda",
                   "adversarial_entropy_minimization")
UDA_BF16 = ("entropy_minimization", "adversarial_entropy_minimization")
UDA_BATCH, UDA_STEPS = 8, 3
# phase 9: 3 train steps a run; coco_merged's keypoint pairs and loss params
# (configs/experiment/coco_merged.yaml), put on DLA-34 in run d
P9_STEPS = 3
NUM_KPS = 5
KP_INDICES = [[0, 1], [0, 4], [1, 4], [2, 3], [1, 2], [4, 3]]
COCO_MERGED_LOSS = [
    "model.backend.loss.params.periodic=true",
    "model.backend.loss.params.kp_weight=2.0",
    f"model.backend.loss.params.kp_indices={KP_INDICES}",
    "model.backend.loss.params.kp_distance_weight=10.0"]
# the new backbones' f32 heads on the card against the same module on the
# CPU (run there in float64): 1e-3 of scale
CARD_VS_CPU = 1e-3
# phase 7's coco_merged run: two source folders of this many images
MERGED_IMAGES = 16
# TensorBoard detection images an eval phase of a CLI run writes (about 0.35
# s an image on the card host), but for the two f32 runs whose eval phases
# are timed side by side, which keep the config's 50
CLI_VISUALIZATIONS = 2
# the host library's functions a CLI run on axis-aligned boxes calls
NATIVE_FUNCTIONS = ("encode_targets", "normalize_image", "coco_greedy_match")
# phase 11, the host-pipeline bench (tools/bench_pipeline_torch.py): its
# JPEG set, input size, batch, loader threads and seconds a loader run
PIPE_IMAGES, PIPE_SIZE, PIPE_BATCH = 64, 512, 16
PIPE_WORKERS, PIPE_SECONDS = (4, 8), 8.0
# phase 11's early stop of a process loader (ROADMAP C3): workers, images,
# stops, and the seconds a stop may take (the subprocess's own limit beside)
STOP_WORKERS, STOP_IMAGES, STOP_TIMES, STOP_LIMIT_S = 8, 32, 3, 30.0
STOP_PROCESS_TIMEOUT_S = 180
# phase 12, the bench (python -m centernet_uda_torch.bench): its runs' knobs,
# how far its train rate may lie from phase 4's steps, its time limit a run
BENCH_RUNS = {
    "bfloat16": {"BENCH_STEPS": "10"},
    "float32": {"BENCH_STEPS": "10", "BENCH_DTYPE": "float32",
                "BENCH_800": "0", "BENCH_PIPELINE": "0"},
}
BENCH_RATE_TOL = 0.2
BENCH_TIMEOUT_S = 400
# phase 13, the compiled steps: (experiment, precision, batch, as the trainers
# of a one-rank NCCL group) at TRAIN_SIZE, each trained by two eager
# trainers and one graphed trainer from one seed,
# GRAPH_STEPS steps, then a MultiStepLR milestone (epoch_end) and
# GRAPH_LR_STEPS more, each step from one state (``parity_run``); a graphed
# run's stats and parameters must lie within GRAPH_SPREAD times the two
# eager runs' spread, plus GRAPH_FLOOR of their scale (for a spread of 0:
# the stats of a deterministic forward; the DCN backwards add with float
# atomics, so the parameters always part); the step after the milestone
# may move no parameter by more than GRAPH_LR_RATIO of the largest move of
# the last step before it (the milestone's gamma is 0.1); GRAPH_TIMED more
# steps give the median step ms, two more the profile; the batch-1 512 px
# serving call (forward plus decode) is timed over SERVE_CALLS calls each way
GRAPH_RUNS = (("baseline", "float32", TRAIN_BATCH, False),
              ("baseline", "bfloat16", TRAIN_BATCH, False),
              *((name, "bfloat16", UDA_BATCH, False)
                for name in UDA_EXPERIMENTS),
              ("baseline", "float32", TRAIN_BATCH, True),
              ("baseline", "bfloat16", TRAIN_BATCH, True),
              ("keypoints", "bfloat16", TRAIN_BATCH, False))
GRAPH_STEPS, GRAPH_LR_STEPS, GRAPH_TIMED = 3, 2, 3
GRAPH_SPREAD, GRAPH_FLOOR, GRAPH_LR_RATIO = 4.0, 1e-6, 0.5
SERVE_CALLS = 20
# H100 SXM published peaks (dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
TOL = 5e-2
STAT_RTOL = 1e-5
# the bf16 model on the kernel path against the same bf16 model on the
# exact op: both round every layer to bf16, but the fused layer keeps its
# offsets in f32 and returns bf16 where the exact path rounds the offsets to
# bf16 and returns f32, so the heads differ by bf16 noise grown through the
# layers (tests/test_torch_bf16.py measures the same spread between two
# executions of the JAX package's bf16 model): the median difference is
# held at TOL and the largest at BF16_HEADS_MAX of each head's scale
BF16_HEADS_MAX = 3e-1


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


_START = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _START:.1f} s)", flush=True)


def library_versions() -> str:
    """The image and logging libraries the data path and the CLI may use,
    as this host has them."""
    import importlib

    out = []
    for name in ("cv2", "PIL", "tensorboardX", "tensorboard"):
        try:
            module = importlib.import_module(name)
        except ImportError:
            out.append(f"{name} missing")
        else:
            out.append(f"{name} {getattr(module, '__version__', '?')}")
    return ", ".join(out)


def time_ms(fn, budget_ms: float = 300.0) -> float:
    """Mean wall time on the card of ``fn`` (CUDA events), warmed up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    iters = int(min(50, max(3, budget_ms / max(start.elapsed_time(end),
                                                1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_in_turns(fn, parent_fn):
    """(ms of ``fn``, ms of ``parent_fn``), timed in turns: parent, this,
    this, parent; the parent's None without ``parent_fn``."""
    if parent_fn is None:
        return time_ms(fn), None
    runs = [time_ms(f) for f in (parent_fn, fn, fn, parent_fn)]
    return (runs[1] + runs[2]) / 2, (runs[0] + runs[3]) / 2


def bound_ms(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def make_operands(seed, b, cin, cout, h, w, device):
    """Seeded DCN operands: offsets of std 2, with |dy| > 14 on a few rows
    so the clamp is exercised."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    x = rng.randn(b, cin, h, w).astype(np.float32)
    off = (rng.randn(b, 18, h, w) * 2.0).astype(np.float32)
    off[:, 0, 0, :] = 20.0
    off[:, 8, h - 1, :] = -16.0
    m = rng.rand(b, 9, h, w).astype(np.float32)
    wt = (rng.randn(cout, cin, 3, 3) / math.sqrt(9 * cin)).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    g = rng.randn(b, cout, h, w).astype(np.float32)
    return [torch.from_numpy(v).to(device) for v in (x, off, m, wt, bias, g)]


def make_fused_operands(seed, b, cin, cout, h, w, device):
    """Seeded operands of the fused layer: bf16 x and g; offset-conv
    weights scaled so the offsets have std about 2; input channel 0 is zero
    except on the first and last rows, where the offset conv lifts dy of
    taps 0 and 4 to +-20, past the clamp.

    Kernel and twin compute the offset conv in different summation orders,
    and the sampler's offset gradient jumps where an offset crosses an
    integer. So x is drawn in steps of 1/8 and the offset-conv weights and
    bias in steps of 1/64: every partial sum is a multiple of 1/512, exact
    in f32 in any order, and the bias is shifted by 1/1024, so every offset
    lies at least 1/1024 from an integer and from the clamp on both
    sides."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    x = (np.round(rng.randn(b, cin, h, w) * 8) / 8).astype(np.float32)
    om_w = (np.round(rng.randn(27, cin, 3, 3) * 128 / math.sqrt(9 * cin))
            / 64).astype(np.float32)
    om_b = (np.round(rng.randn(27) * 32) / 64 + 1 / 1024).astype(np.float32)
    x[:, 0] = 0.0
    x[:, 0, 0, :] = 4.0
    x[:, 0, h - 1, :] = -4.0
    om_w[:, 0] = 0.0
    om_w[0, 0, 1, 1] = om_w[8, 0, 1, 1] = 5.0
    wt = (rng.randn(cout, cin, 3, 3) / math.sqrt(9 * cin)).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    g = rng.randn(b, cout, h, w).astype(np.float32)
    t = [torch.from_numpy(v).to(device) for v in (x, om_w, om_b, wt, bias,
                                                   g)]
    t[0], t[5] = t[0].bfloat16(), t[5].bfloat16()
    return t


def compare(name, got, want):
    """(max abs error, error relative to max|want|); raises past TOL."""
    import torch

    got, want = got.double(), want.double()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    scale = max(1.0, float(want.abs().max()))
    err = (got - want).abs()
    if bool((err > TOL * scale + TOL * want.abs()).any()):
        raise AssertionError(f"{name}: max |err| {float(err.max())} exceeds "
                             f"atol {TOL * scale} + rtol {TOL}")
    return float(err.max()), float(err.max()) / scale


def dcn_shapes(model, size, device):
    """{(cin, cout, h, w): layers} of the DCN layers at ``size`` px."""
    import torch

    from centernet_uda_torch.ops.dcn import DCN

    shapes = {}

    def hook(mod, args):
        x = args[0]
        key = (x.shape[1], mod.weight.shape[0], x.shape[2], x.shape[3])
        shapes[key] = shapes.get(key, 0) + 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, DCN)]
    model.eval()
    with torch.no_grad():
        model(torch.zeros(1, 3, size, size, device=device))
    for h in handles:
        h.remove()
    return shapes


def print_record(label, batch, cin, cout, h, w, layers, errs, t, fb, fk, bb,
                 bk):
    parent = {d: (f", parent {t[f'parent_{d}_ms']:.3f}"
                  if f"parent_{d}_ms" in t else "") for d in ("fwd", "bwd")}
    print(f"{label} B={batch} {cin}->{cout} @{h}x{w} (x{layers}): "
          f"errs " + " ".join(f"{k}={v[0]:.3g}/{v[1]:.2g}"
                              for k, v in errs.items())
          + f" | fwd {t['fwd_ms']:.3f} ms (twin {t['twin_fwd_ms']:.3f},"
          f" conv {t['conv_fwd_ms']:.3f}{parent['fwd']}, bound {fb:.4f} {fk})"
          f" | bwd {t['bwd_ms']:.3f} ms (twin {t['twin_bwd_ms']:.3f},"
          f" conv {t['conv_bwd_ms']:.3f}{parent['bwd']}, bound {bb:.4f} {bk})",
          flush=True)


EXPLICIT_PAIRS = {"f32": ("dcn_forward", "dcn_backward"),
                  "select": ("dcn_sel_forward", "dcn_sel_backward")}


def check_kernels(shapes, batch, device, label, pair="f32",
                  dtype="float32", parent=None):
    """Phase 3 for an explicit-offset kernel pair at one input size:
    ``pair`` "f32" (``dcn_forward``/``dcn_backward``, float32 only) or
    "select" (``dcn_sel_forward``/``dcn_sel_backward``, x, g, out, dx and
    the weight in ``dtype``). Returns per-shape records. The yardstick is
    cuDNN's convolution of the same shape in the same dtype. ``parent``,
    another checkout's ``dcn_cuda`` module, has its pair timed beside this
    one's, in turns."""
    import torch
    import torch.nn.functional as F

    from centernet_uda_torch.ops import dcn_cuda

    fwd, bwd = (getattr(dcn_cuda, n) for n in EXPLICIT_PAIRS[pair])
    parent_fwd, parent_bwd = (parent and getattr(parent, n)
                              for n in EXPLICIT_PAIRS[pair])
    dt = getattr(torch, dtype)
    elem = torch.finfo(dt).bits // 8
    records = []
    for i, ((cin, cout, h, w), layers) in enumerate(sorted(shapes.items())):
        x, off, m, wt, bias, g = make_operands(i, batch, cin, cout, h, w,
                                               device)
        x, wt, g = x.to(dt), wt.to(dt), g.to(dt)
        out = fwd(x, off, m, wt, bias)
        ref = dcn_cuda.dcn_v2_twin(x, off, m, wt, bias)
        if out.dtype != dt:
            raise AssertionError(f"{pair} forward gave {out.dtype}")
        errs = {"out": compare("out", out, ref)}
        del out, ref
        got = bwd(x, off, m, wt, g) + (g.float().sum((0, 2, 3)),)
        leaves = [t.clone().requires_grad_(True) for t in (x, off, m, wt,
                                                           bias)]
        with torch.enable_grad():
            ref_out = dcn_cuda.dcn_v2_twin(*leaves)
            want = torch.autograd.grad(ref_out, leaves, g)
        for name, a, b in zip(("dx", "doff", "dmask", "dw", "dbias"), got,
                              want):
            if a.dtype != b.dtype:
                raise AssertionError(f"{pair} {name} is {a.dtype}, its twin "
                                     f"{b.dtype}")
            errs[name] = compare(name, a, b)
        del got, want, ref_out, leaves
        torch.cuda.synchronize()

        n = batch * h * w
        fwd_flops = 2.0 * n * cin * cout * 9
        # each input read once, each output written once: x, offset,
        # mask, W (+ bias) in, out; backward x, offset, mask, W, g in, dx,
        # doffset, dmask, dW, dbias out
        weights = elem * 9 * cin * cout
        fwd_bytes = (elem * n * (cin + cout) + 4.0 * n * 27 + weights
                     + 4.0 * cout)
        bwd_bytes = (elem * n * (2 * cin + cout) + 4.0 * n * 27 * 2
                     + 2 * weights + 4.0 * cout)
        fwd_ms, parent_fwd_ms = time_in_turns(
            lambda: fwd(x, off, m, wt, bias),
            parent_fwd and (lambda: parent_fwd(x, off, m, wt, bias)))
        bwd_ms, parent_bwd_ms = time_in_turns(
            lambda: bwd(x, off, m, wt, g),
            parent_bwd and (lambda: parent_bwd(x, off, m, wt, g)))
        t = {
            "fwd_ms": fwd_ms,
            "twin_fwd_ms": time_ms(lambda: dcn_cuda.dcn_v2_twin(
                x, off, m, wt, bias)),
            "conv_fwd_ms": time_ms(lambda: F.conv2d(x, wt, bias.to(dt),
                                                    padding=1)),
            "bwd_ms": bwd_ms,
            "twin_bwd_ms": time_ms(lambda: dcn_cuda.dcn_backward_plain(
                x, off, m, wt, g)),
            "conv_bwd_ms": time_ms(
                lambda: torch.ops.aten.convolution_backward(
                    g, x, wt, [cout], [1, 1], [1, 1], [1, 1], False, [0, 0],
                    1, [True, True, True])),
        }
        if parent_fwd_ms is not None:
            t["parent_fwd_ms"] = parent_fwd_ms
            t["parent_bwd_ms"] = parent_bwd_ms
        fb, fk = bound_ms(fwd_bytes, fwd_flops)
        bb, bk = bound_ms(bwd_bytes, 2 * fwd_flops)
        records.append({
            "path": label, "dtype": dtype, "batch": batch, "cin": cin,
            "cout": cout, "h": h, "w": w, "layers": layers,
            "max_abs_err": {k: v[0] for k, v in errs.items()},
            "max_rel_err": {k: v[1] for k, v in errs.items()},
            "fwd_bound_ms": fb, "fwd_bound_by": fk,
            "bwd_bound_ms": bb, "bwd_bound_by": bk, **t})
        print_record(f"{pair} {dtype} {label}", batch, cin, cout, h, w,
                     layers, errs, t, fb, fk, bb, bk)
        del x, off, m, wt, bias, g
        torch.cuda.empty_cache()
    return records


def check_wide_kernel(shapes, batch, device, label, dtype="float32",
                      parent=None):
    """Phase 3 for the wide forward (both offsets clamped) in ``dtype``:
    against ``dcn_v2_twin(..., clamp_dx=True)``, with dx scaled to std 16
    so many samples pass the clamp, and timed in turns beside ``parent``'s
    where given. Its backward is the exact op's, not a kernel. Returns
    per-shape records."""
    import torch
    import torch.nn.functional as F

    from centernet_uda_torch.ops import dcn_cuda

    dt = getattr(torch, dtype)
    elem = torch.finfo(dt).bits // 8
    records = []
    for i, ((cin, cout, h, w), layers) in enumerate(sorted(shapes.items())):
        x, off, m, wt, bias, _ = make_operands(200 + i, batch, cin, cout, h,
                                               w, device)
        off[:, 1::2] *= 8.0
        x = x.to(dt)
        out = dcn_cuda.dcn_wide_forward(x, off, m, wt, bias)
        ref = dcn_cuda.dcn_v2_twin(x, off, m, wt, bias, clamp_dx=True)
        if out.dtype != dt:
            raise AssertionError(f"wide forward gave {out.dtype}")
        errs = {"out": compare("out", out, ref)}
        del out, ref
        torch.cuda.synchronize()
        n = batch * h * w
        flops = 2.0 * n * cin * cout * 9
        nbytes = (elem * n * (cin + cout) + 4.0 * n * 27 + 4.0 * 9 * cin
                  * cout + 4.0 * cout)
        fwd_ms, parent_fwd_ms = time_in_turns(
            lambda: dcn_cuda.dcn_wide_forward(x, off, m, wt, bias),
            parent and (lambda: parent.dcn_wide_forward(x, off, m, wt, bias)))
        t = {
            "fwd_ms": fwd_ms,
            "twin_fwd_ms": time_ms(lambda: dcn_cuda.dcn_v2_twin(
                x, off, m, wt, bias, clamp_dx=True)),
            "conv_fwd_ms": time_ms(lambda: F.conv2d(
                x, wt.to(dt), bias.to(dt), padding=1)),
        }
        if parent_fwd_ms is not None:
            t["parent_fwd_ms"] = parent_fwd_ms
        fb, fk = bound_ms(nbytes, flops)
        records.append({
            "path": label, "dtype": dtype, "batch": batch, "cin": cin,
            "cout": cout, "h": h, "w": w, "layers": layers,
            "max_abs_err": {k: v[0] for k, v in errs.items()},
            "max_rel_err": {k: v[1] for k, v in errs.items()},
            "fwd_bound_ms": fb, "fwd_bound_by": fk, **t})
        print(f"wide {dtype} {label} B={batch} {cin}->{cout} @{h}x{w} "
              f"(x{layers}): err {errs['out'][0]:.3g}/{errs['out'][1]:.2g} "
              f"| fwd {t['fwd_ms']:.3f} ms (twin {t['twin_fwd_ms']:.3f}, "
              f"conv {t['conv_fwd_ms']:.3f}"
              + (f", parent {parent_fwd_ms:.3f}" if parent else "")
              + f", bound {fb:.4f} {fk})", flush=True)
        del x, off, m, wt, bias
        torch.cuda.empty_cache()
    return records


def check_fused_kernels(shapes, batch, device, label, parent=None):
    """Phase 3 for the fused bf16 kernels at one input size; returns
    per-shape records. The yardstick is one cuDNN bf16 convolution of
    Cin -> Cout + 27 (the layer with zero offsets and mask 1, plus the
    offset conv, on the same input) and its convolution_backward.
    ``parent``, another checkout's ``dcn_cuda`` module, is timed beside the
    kernels, in turns."""
    import torch
    import torch.nn.functional as F

    from centernet_uda_torch.ops import dcn_cuda

    records = []
    for i, ((cin, cout, h, w), layers) in enumerate(sorted(shapes.items())):
        x, om_w, om_b, wt, bias, g = make_fused_operands(
            100 + i, batch, cin, cout, h, w, device)
        out, stat = dcn_cuda.dcn_fused_forward(x, om_w, om_b, wt, bias)
        ref, ref_stat = dcn_cuda.dcn_v2_fused_twin(x, om_w, om_b, wt, bias)
        errs = {"out": compare("out", out, ref)}
        stat_err = abs(float(stat) - float(ref_stat))
        if not (float(ref_stat) > 14.0
                and stat_err <= STAT_RTOL * float(ref_stat)):
            raise AssertionError(f"max |dy| {float(stat)} vs twin "
                                 f"{float(ref_stat)}")
        errs["stat"] = (stat_err, stat_err / float(ref_stat))
        del out, ref
        got = dcn_cuda.dcn_fused_backward(x, om_w, om_b, wt, g) + (
            g.float().sum((0, 2, 3)),)
        leaves = [t.clone().requires_grad_(True) for t in (x, om_w, om_b,
                                                           wt, bias)]
        with torch.enable_grad():
            ref_out, _ = dcn_cuda.dcn_v2_fused_twin(*leaves)
            want = torch.autograd.grad(ref_out, leaves, g)
        for name, a, b in zip(("dx", "dom_w", "dom_b", "dw", "dbias"), got,
                              want):
            errs[name] = compare(name, a, b)
        del got, want, ref_out, leaves
        torch.cuda.synchronize()

        n = batch * h * w
        fwd_flops = 2.0 * n * 9 * cin * (cout + 27)
        params = 4.0 * (9 * cin * (cout + 27) + cout + 27)
        fwd_bytes = 2.0 * n * (cin + cout) + params
        bwd_bytes = 2.0 * n * (cin + cout + cin) + 2 * params
        w_cat = torch.cat([wt, om_w]).bfloat16()
        g_cat = g.repeat(1, 1 - (-27 // cout), 1, 1)[:, :cout + 27]
        g_cat = g_cat.contiguous()
        fwd = {name: (lambda m=m: m.dcn_fused_forward(x, om_w, om_b, wt,
                                                      bias))
               for name, m in (("", dcn_cuda), ("parent_", parent)) if m}
        bwd = {name: (lambda m=m: m.dcn_fused_backward(x, om_w, om_b, wt, g))
               for name, m in (("", dcn_cuda), ("parent_", parent)) if m}
        t = {}
        for d, fns in (("fwd", fwd), ("bwd", bwd)):
            t[f"{d}_ms"], parent_ms = time_in_turns(fns[""],
                                                    fns.get("parent_"))
            if parent_ms is not None:
                t[f"parent_{d}_ms"] = parent_ms
        t.update({
            "twin_fwd_ms": time_ms(lambda: dcn_cuda.dcn_v2_fused_twin(
                x, om_w, om_b, wt, bias)),
            "conv_fwd_ms": time_ms(lambda: F.conv2d(x, w_cat, None,
                                                    padding=1)),
            "twin_bwd_ms": time_ms(lambda: dcn_cuda.dcn_fused_backward_plain(
                x, om_w, om_b, wt, g)),
            "conv_bwd_ms": time_ms(
                lambda: torch.ops.aten.convolution_backward(
                    g_cat, x, w_cat, None, [1, 1], [1, 1], [1, 1], False,
                    [0, 0], 1, [True, True, False])),
        })
        fb, fk = bound_ms(fwd_bytes, fwd_flops)
        bb, bk = bound_ms(bwd_bytes, 2 * fwd_flops)
        records.append({
            "path": label, "batch": batch, "cin": cin, "cout": cout, "h": h,
            "w": w, "layers": layers,
            "max_abs_err": {k: v[0] for k, v in errs.items()},
            "max_rel_err": {k: v[1] for k, v in errs.items()},
            "fwd_bound_ms": fb, "fwd_bound_by": fk,
            "bwd_bound_ms": bb, "bwd_bound_by": bk, **t})
        print_record(label, batch, cin, cout, h, w, layers, errs, t, fb, fk,
                     bb, bk)
        del x, om_w, om_b, wt, bias, g, w_cat, g_cat
        torch.cuda.empty_cache()
    return records


def profile_launches(label, fn, want):
    """One call of ``fn`` under torch.profiler: the DCN kernels it launches
    (there must be ``want``) and each launch's device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the profiler now and then returns a cycle without device events; a
    # profile that saw no DCN kernel at all is taken again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launches = [(ev.name, ev.device_time_total / 1e3)
                    for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA
                    and "dcn_" in ev.name]
        if launches:
            break
    if len(launches) != want:
        raise AssertionError(f"{label} launched {len(launches)} kernels, "
                             f"not {want}: {launches}")
    print(f"{label}: {want} launch(es) per call: " + ", ".join(
        f"{name.split('(')[0].split('<')[0].split(' ')[-1]} {ms:.3f} ms"
        for name, ms in launches), flush=True)
    return launches


def profile_fused_call(shape, batch, device):
    """One call of each fused wrapper at ``shape`` under torch.profiler:
    the forward must launch 1 kernel, the backward 4."""
    import torch

    from centernet_uda_torch.ops import dcn_cuda

    cin, cout, h, w = shape
    x, om_w, om_b, wt, bias, g = make_fused_operands(7, batch, cin, cout, h,
                                                     w, device)
    where = f"B={batch} {cin}->{cout} @{h}x{w}"
    record = {
        "fwd": profile_launches(
            f"fused fwd {where}",
            lambda: dcn_cuda.dcn_fused_forward(x, om_w, om_b, wt, bias), 1),
        "bwd": profile_launches(
            f"fused bwd {where}",
            lambda: dcn_cuda.dcn_fused_backward(x, om_w, om_b, wt, g), 4)}
    del x, om_w, om_b, wt, bias, g
    torch.cuda.empty_cache()
    return record


def profile_explicit_pair(pair, dtype, shape, batch, device):
    """One call of each wrapper of the explicit-offset ``pair`` ("f32" or
    "select") in ``dtype`` at ``shape`` under torch.profiler: the forward
    must launch 1 kernel, the backward 2."""
    import torch

    from centernet_uda_torch.ops import dcn_cuda

    cin, cout, h, w = shape
    x, off, m, wt, bias, g = make_operands(8, batch, cin, cout, h, w, device)
    dt = getattr(torch, dtype)
    x, wt, g = x.to(dt), wt.to(dt), g.to(dt)
    fwd, bwd = (getattr(dcn_cuda, n) for n in EXPLICIT_PAIRS[pair])
    where = f"{pair} {dtype} B={batch} {cin}->{cout} @{h}x{w}"
    record = {
        "fwd": profile_launches(f"{where} fwd",
                                lambda: fwd(x, off, m, wt, bias), 1),
        "bwd": profile_launches(f"{where} bwd",
                                lambda: bwd(x, off, m, wt, g), 2)}
    del x, off, m, wt, bias, g
    torch.cuda.empty_cache()
    return record


def load_parent(path):
    """Another checkout's ``ops/dcn_cuda.py`` as a module of its own: its
    kernel sources, built into that checkout's ``build/kernels/``."""
    import importlib.util

    src = Path(path).resolve() / "centernet_uda_torch" / "ops" / "dcn_cuda.py"
    spec = importlib.util.spec_from_file_location("parent_dcn_cuda", src)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    t0 = time.time()
    module.build_kernels()
    print(f"parent checkout {path}: kernels built in {time.time() - t0:.1f} "
          f"s", flush=True)
    return module


def synthetic_batch(rng, batch, size, num_classes, max_det, down_ratio=4,
                    rotated=False, num_kps=0):
    """A seeded detection batch, targets encoded as the data pipeline
    does; with ``rotated`` the ``wh`` target carries an angle in degrees
    and ``gt_dets`` is (cx, cy, w, h, angle, 1, class); with ``num_kps``
    keypoint offsets, their mask and ``gt_kps``."""
    import numpy as np

    from centernet_uda_torch.ops.gaussian import encode_targets

    out = size // down_ratio
    per_image = []
    for _ in range(batch):
        n = rng.randint(5, 30)
        xy = rng.rand(n, 2) * out * 0.85
        wh = rng.rand(n, 2) * out * 0.25 + 2.0
        boxes = np.concatenate([xy, np.minimum(xy + wh, out - 1)], 1)
        t = encode_targets(boxes, rng.randint(0, num_classes, n), out, out,
                           num_classes, max_det)
        valid = t["reg_mask"][:, None].astype(np.float32)
        if rotated:
            angle = rng.uniform(-90, 90, (max_det, 1)).astype(np.float32)
            t["wh"] = np.concatenate([t["wh"], angle * valid], 1)
            d = t["gt_dets"]
            t["gt_dets"] = np.concatenate(
                [(d[:, 0:2] + d[:, 2:4]) / 2, d[:, 2:4] - d[:, 0:2], angle,
                 d[:, 4:6]], 1) * valid
        if num_kps:
            t["kps"] = (rng.randn(max_det, 2 * num_kps) * 3).astype(
                np.float32) * valid
            t["kp_reg_mask"] = np.repeat(
                (rng.rand(max_det, num_kps) > 0.2) & (valid > 0), 2,
                1).astype(np.uint8)
            t["gt_kps"] = (rng.rand(max_det, num_kps, 2) * out).astype(
                np.float32)
        per_image.append(t)
    data = {k: np.stack([t[k] for t in per_image]) for k in per_image[0]}
    data["input"] = rng.randn(batch, 3, size, size).astype(np.float32)
    data["id"] = np.arange(batch)
    return data


def check_heads_against_exact(trainer, device, bf16=False):
    """The model on the kernel path against the exact DCN op: same weights,
    a 2 x 3 x 256 x 256 input, on a copy of the model with train-mode
    BatchNorm (at init, eval-mode features are too small to compare)."""
    import copy

    import numpy as np
    import torch

    from centernet_uda_torch.ops.dcn import DCN

    net = copy.deepcopy(trainer.backend.module).train()
    x = torch.from_numpy(np.random.RandomState(7).randn(
        2, 3, 256, 256).astype(np.float32)).to(device)

    def heads(impl):
        for m in net.modules():
            if isinstance(m, DCN):
                m.impl = impl
        with torch.no_grad():
            return net(x)

    got, want = heads("auto"), heads("xla")
    del net
    if bf16:
        errs = {}
        for k in want:
            err = (got[k].double() - want[k].double()).abs()
            scale = float(want[k].abs().max())
            med, top = float(err.median()), float(err.max())
            if not (bool(torch.isfinite(got[k]).all())
                    and med <= TOL * scale and top <= BF16_HEADS_MAX * scale):
                raise AssertionError(f"bf16 head {k}: median |err| {med}, "
                                     f"max {top}, scale {scale}")
            errs[k] = (top, top / scale)
    else:
        errs = {k: compare(f"head {k}", got[k], want[k]) for k in want}
    print(f"{'bf16' if bf16 else 'f32'} heads on the kernel path vs the "
          f"exact DCN op: " + " ".join(f"{k}={v[0]:.3g}/{v[1]:.2g}"
                                       for k, v in errs.items()), flush=True)
    return {k: v[0] for k, v in errs.items()}


def expect(**counts):
    """The launch counters with ``counts`` and every other kernel at 0."""
    from centernet_uda_torch.ops import dcn_cuda

    return {name: counts.get(name, 0) for name in dcn_cuda.LAUNCHES}


def train_and_eval(trainer, cfg, data, eval_data, per_step, per_eval,
                   steps=TRAIN_STEPS, after_step=None):
    """Phases 4, 5 and 8 for one trainer: ``steps`` train steps, then one
    eval step with decode. ``per_step``/``per_eval`` are the launches each
    kernel must make in one train step / the eval step; every other kernel
    must not launch. ``after_step(trainer)``, if given, runs after each
    train step (outside the timed region)."""
    import numpy as np
    import torch

    from centernet_uda_torch.ops import dcn_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    dcn_cuda.reset_launches()
    for i in range(steps):
        t0 = time.perf_counter()
        stats = trainer.step(data, is_training=True)["stats"]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if after_step is not None:
            after_step(trainer)
        vals = {k: float(v) for k, v in stats.items()}
        if trainer.maybe_degrade_dcn(vals.get("dcn_max_abs_dy", 0.0)):
            raise AssertionError("the DCN offsets reached the clamp")
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"non-finite train stats {vals}")
        losses.append(vals)
        print(f"step {i}: {step_ms[-1]:.1f} ms " + " ".join(
            f"{k}={v:.5f}" for k, v in vals.items()), flush=True)
    train_launches = dict(dcn_cuda.LAUNCHES)
    want = {k: v * steps for k, v in per_step.items()}
    if train_launches != want:
        raise AssertionError(f"launches {train_launches} != {want}")
    peak = torch.cuda.max_memory_allocated()
    print(f"launches {train_launches}; peak memory {peak / 2**30:.2f} GiB",
          flush=True)
    train = {"step_ms": step_ms, "stats": losses, "launches": train_launches,
             "max_memory_allocated": peak}

    dcn_cuda.reset_launches()
    t0 = time.perf_counter()
    outputs = trainer.step(eval_data, is_training=False)
    dets = trainer.get_detections(outputs, eval_data)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    eval_launches = dict(dcn_cuda.LAUNCHES)
    if eval_launches != per_eval:
        raise AssertionError(f"eval launches {eval_launches} != "
                             f"{per_eval}")
    vals = {k: float(v) for k, v in outputs["stats"].items()}
    boxes = dets["pred_boxes"]
    max_det = int(cfg.max_detections)
    backend = trainer.backend
    batch = int(cfg.batch_size)
    if boxes.shape != (batch, max_det, 5 if backend.rotated_boxes else 4):
        raise AssertionError(f"pred_boxes shape {boxes.shape}")
    kps = dets.get("pred_kps")
    if backend.num_keypoints and (
            kps is None or kps.shape != (batch, max_det,
                                         backend.num_keypoints, 2)
            or not np.isfinite(kps).all()):
        raise AssertionError(f"pred_kps {None if kps is None else kps.shape}")
    if not (np.isfinite(boxes).all() and np.isfinite(dets["pred_scores"]).all()
            and all(math.isfinite(v) for v in vals.values())):
        raise AssertionError("non-finite eval outputs")
    if trainer.maybe_degrade_dcn(vals.get("dcn_max_abs_dy", 0.0)):
        raise AssertionError("the DCN offsets reached the clamp in eval")
    print(f"eval {eval_data['input'].shape[-1]}px B={cfg.batch_size}: "
          f"{eval_ms:.1f} ms, "
          f"pred_boxes {boxes.shape}, launches {eval_launches}, " + " ".join(
              f"{k}={v:.5f}" for k, v in vals.items()), flush=True)
    return train, {"ms": eval_ms, "stats": vals, "launches": eval_launches}


def profile_train_steps(trainer, data, steps=2, top=12):
    """Device time of ``steps`` train steps by kernel (torch.profiler), the
    DCN kernels' share and the device's busy share of the wall time. The
    kernels of a replayed CUDA graph keep their names in the trace
    (phase 13 checks that its graphed profiles hold the DCN kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.step(data, is_training=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + (
                ev.device_time_total / 1e3)
    device_ms = sum(kernels.values())
    dcn_ms = sum(v for k, v in kernels.items() if "dcn" in k)
    rows = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    print(f"profile of {steps} train steps: wall {wall_ms:.1f} ms, device "
          f"busy {device_ms:.1f} ms ({device_ms / wall_ms:.1%}), DCN kernels "
          f"{dcn_ms:.1f} ms ({dcn_ms / max(device_ms, 1e-9):.1%} of device)")
    for name, ms in rows:
        print(f"  {ms / steps:9.3f} ms/step  {name[:110]}")
    return {"steps": steps, "wall_ms": wall_ms, "device_ms": device_ms,
            "busy": device_ms / wall_ms, "dcn_kernels_ms": dcn_ms,
            "top_kernels_ms_per_step": {k: v / steps for k, v in rows}}


def train_state(trainer):
    """The tensors a train step updates in place: the backend's (and ADVENT's
    discriminator's) parameters and buffers, and the optimizers' state."""
    import torch

    out = []
    for m in (trainer.backend.module, getattr(trainer, "discriminator", None)):
        if m is not None:
            out += list(m.parameters()) + list(m.buffers())
    for opt in (trainer.optimizer, getattr(trainer, "disc_optimizer", None)):
        for st in (opt.state.values() if opt is not None else ()):
            out += [v for v in st.values() if isinstance(v, torch.Tensor)]
    return out


def backend_params(trainer):
    import torch

    return torch.cat([p.detach().flatten().float()
                      for p in trainer.backend.module.parameters()])


def spread_check(label, what, eager, eager2, graphed, norm):
    """Per step, ``graphed`` against ``eager`` beside ``eager2`` against
    ``eager`` (lists of tensors, one a step), by ``norm`` (``max``: the
    largest element difference; ``l2``: the norm of the difference); the
    largest graphed difference within GRAPH_SPREAD times the largest eager
    one plus GRAPH_FLOOR of the scale."""
    import torch

    def size(t):
        t = t.double()
        return float(t.abs().max() if norm == "max" else t.norm())

    diff = max(size(g - e) for e, g in zip(eager, graphed))
    spread = max(size(e2 - e) for e, e2 in zip(eager, eager2))
    scale = max(size(e) for e in eager)
    bound = GRAPH_SPREAD * spread + GRAPH_FLOOR * scale
    print(f"{label} {what} ({norm}): graphed vs eager {diff:.4g}, eager vs "
          f"eager {spread:.4g}, bound {bound:.4g}", flush=True)
    if not (all(bool(torch.isfinite(g).all()) for g in graphed)
            and diff <= bound):
        raise AssertionError(f"{label} {what}: graphed off eager by {diff} "
                             f"> {bound}")
    return {"graphed_vs_eager": diff, "eager_vs_eager": spread}


def timed_steps(trainer, data, steps, per_step):
    """``steps`` train steps, each ended by a synchronisation and launching
    exactly ``per_step``; returns (their ms, their stats)."""
    import torch

    from centernet_uda_torch.ops import dcn_cuda

    ms, stats = [], []
    for _ in range(steps):
        dcn_cuda.reset_launches()
        t0 = time.perf_counter()
        out = trainer.step(data, is_training=True)["stats"]
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if dict(dcn_cuda.LAUNCHES) != per_step:
            raise AssertionError(f"launches {dict(dcn_cuda.LAUNCHES)} != "
                                 f"{per_step}")
        stats.append(torch.stack([out[k].float() for k in sorted(out)]))
    return ms, stats


def serve_ms(net, graphs):
    """Median ms of SERVE_CALLS batch-1 TRAIN_SIZE forward-plus-decode
    calls (``bench._infer_fn``), each ended by a synchronisation; graphed
    where ``graphs`` is a StepGraphs (after its eager and capturing call),
    else eager. Returns (ms, the call's detections)."""
    import numpy as np
    import torch

    from centernet_uda_torch.bench import _infer_fn

    x = torch.from_numpy(np.random.RandomState(5).randn(
        1, 3, TRAIN_SIZE, TRAIN_SIZE).astype(np.float32)).cuda()
    infer = _infer_fn(net.eval(), x, graphs)
    for _ in range(2):
        dets = infer()
    times = []
    for _ in range(SERVE_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = infer()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), dets


class DropMasks:
    """EfficientNet's stochastic-depth masks of each train step, while
    active (it wraps ``efficientnet.drop_connect``). ``step_done()`` after
    a synchronised step keeps a copy of the masks of the step's last draw:
    an eager step's, a capturing step's (the captured tensors, which its
    replay fills), or, for a replay, which runs no Python, the captured
    tensors again, filled by that replay."""

    def __init__(self):
        self.drawn, self.current, self.steps = [], [], []

    def __enter__(self):
        from centernet_uda_torch.models import efficientnet

        self.module, self.draw = efficientnet, efficientnet.drop_connect

        def recording(x, keep, mask):
            self.drawn.append(mask)
            return self.draw(x, keep, mask)

        efficientnet.drop_connect = recording
        return self

    def __exit__(self, *exc):
        self.module.drop_connect = self.draw

    def step_done(self):
        if self.drawn:
            self.current, self.drawn = self.drawn, []
        self.steps.append([m.clone() for m in self.current])


def parity_run(trainer, data, per_step, snapshots, record, masks=None):
    """GRAPH_STEPS train steps, ``epoch_end`` (the milestone), GRAPH_LR_STEPS
    more. Before each step the trainer's state is the first eager run's
    before that step: ``snapshots`` collects it on that run and is loaded
    (in place: a graph's state tensors keep their addresses) on the others,
    so that each step is compared from one state (Adam moves an element
    whose gradient is below the atomics' noise by +-lr either way, and
    those steps would part the trajectories whatever runs them). Records
    each step's stats and backend parameters, and the largest parameter
    move of the step before the milestone and of the last step; with
    ``masks`` (a ``DropMasks``), each step's stochastic-depth masks."""
    import torch

    n = GRAPH_STEPS + GRAPH_LR_STEPS
    for i in range(n):
        if i == GRAPH_STEPS:
            trainer.epoch_end()
            if trainer.step_graphs is not None and len(trainer.step_graphs):
                raise AssertionError("the milestone left the graphs")
        state = train_state(trainer)
        if len(snapshots) <= i:
            snapshots.append([t.detach().clone() for t in state])
        else:
            with torch.no_grad():
                for t, v in zip(state, snapshots[i]):
                    t.copy_(v)
        before = backend_params(trainer)
        ms, stats = timed_steps(trainer, data, 1, per_step)
        if masks is not None:
            masks.step_done()
        record["step_ms"] += ms
        record["stats"] += stats
        record["params"].append(backend_params(trainer))
        move = float((record["params"][-1] - before).abs().max())
        if i in (GRAPH_STEPS - 1, n - 1):
            record["moves"].append(move)


def compiled_steps(n_dcn, seed):
    """Phase 13: for each of GRAPH_RUNS, the graphed step against the eager
    one (see GRAPH_RUNS and ``parity_run``): stats and parameters within the
    spread rule, exact launches per step, the milestone honoured (the
    graphs dropped, the step captured after it at the new rate), then the
    median ms of GRAPH_TIMED more steps, the busy share (torch.profiler
    over 2 steps) and the peak memory above the trainer's resident state,
    eager and graphed. A one-rank run trains every trainer in one NCCL
    group of one rank, and its graphed trainer then takes two eval steps,
    the second captured and replayed. On ``keypoints`` every step's
    stochastic-depth masks, graphed against eager, bit for bit. On DLA-34
    at float32 (no group) also the batch-1 serving call each way, then the
    degrade: after ``maybe_degrade_dcn(PALLAS_MAX_SHIFT)`` the next steps
    capture anew on the exact op and launch no kernel."""
    import numpy as np
    import torch

    from centernet_uda_torch.config import compose
    from centernet_uda_torch.ops.dcn import PALLAS_MAX_SHIFT
    from centernet_uda_torch.parallel import ddp
    from centernet_uda_torch.train import build_trainer
    from centernet_uda_torch.utils.graphs import StepGraphs

    out = {}
    for name, precision, batch, one_rank in GRAPH_RUNS:
        label = (f"{name} {precision} B={batch}"
                 + (" one NCCL rank" if one_rank else ""))
        print(f"-- {label}", flush=True)
        cfg = compose([f"experiment={name}", f"seed={seed}",
                       f"precision={precision}", f"batch_size={batch}",
                       "optimizer.scheduler={name: MultiStepLR, params: "
                       "{milestones: [1], gamma: 0.1}}"],
                      config_dir=str(ROOT / "configs"))
        params = cfg.model.backend.params
        rng = np.random.RandomState(seed + 13)
        data = synthetic_batch(rng, batch, TRAIN_SIZE,
                               int(params.num_classes),
                               int(cfg.max_detections),
                               num_kps=int(params.get("num_keypoints", 0)))
        dla = cfg.model.backend.name == "dla"
        n = (n_dcn if name == "baseline" else 2 * n_dcn) if dla else 0
        if name != "baseline":
            data = with_target_domain(data, rng)
        fwd, bwd = (("dcn_fwd", "dcn_bwd") if precision == "float32" else
                    ("dcn_fused_fwd", "dcn_fused_bwd"))
        per_step = expect(**{fwd: n, bwd: n})
        snapshots, runs, kept = [], {}, {}
        serve = name == "baseline" and precision == "float32" and not one_rank
        if one_rank:
            ddp.init(ddp.Ranks(0, 1, 0, 1, port=ddp.free_port()),
                     torch.device("cuda", 0))
        try:
            for run, graphs in (("eager", False), ("eager2", False),
                                ("graphed", True)):
                trainer = build_trainer(cfg, device="cuda", graphs=graphs)
                trainer.init_done()
                torch.cuda.synchronize()
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                rec = {"step_ms": [], "stats": [], "params": [], "moves": []}
                with DropMasks() as masks:
                    parity_run(trainer, data, per_step, snapshots, rec,
                               masks)
                rec["masks"] = masks.steps
                before, after = rec["moves"]
                lrs = sorted({g["lr"] for g in trainer.optimizer.param_groups})
                if after > GRAPH_LR_RATIO * before:
                    raise AssertionError(
                        f"{label} {run}: a step at lr {lrs} moved a "
                        f"parameter by {after}, the last step before the "
                        f"milestone by {before}")
                if run != "eager2":
                    ms, _ = timed_steps(trainer, data, GRAPH_TIMED, per_step)
                    rec["median_step_ms"] = float(np.median(ms))
                    rec["peak_bytes"] = (torch.cuda.max_memory_allocated()
                                         - resident)
                    prof = profile_train_steps(trainer, data, top=3)
                    rec["busy"] = prof["busy"]
                    if n and prof["dcn_kernels_ms"] <= 0:
                        raise AssertionError(f"{label} {run}: no DCN kernel "
                                             "in the profile")
                    rec["launches"] = {k: v * (GRAPH_STEPS + GRAPH_LR_STEPS
                                               + GRAPH_TIMED)
                                       for k, v in per_step.items()}
                    print(f"{label} {run}: median step "
                          f"{rec['median_step_ms']:.2f} ms, busy "
                          f"{rec['busy']:.1%}, peak above the resident state "
                          f"{rec['peak_bytes'] / 2**30:.2f} GiB; lr {lrs}: "
                          f"largest move {after:.3g} after the milestone, "
                          f"{before:.3g} before", flush=True)
                if graphs:
                    calls = dict(trainer.step_graphs.calls)
                    # eager, capture, replay; the milestone; eager, capture;
                    # then the timed and profiled steps replay
                    if calls["captures"] != 2 or calls["eager"] != 2:
                        raise AssertionError(f"{label}: graph calls {calls}")
                    rec["graph_calls"] = calls
                    if one_rank:
                        rec["eval_graph_calls"] = graphed_eval(trainer, data)
                        print(f"{label}: eval steps' graph calls "
                              f"{rec['eval_graph_calls']} (the second "
                              "captured with its all-reduces, then "
                              "replayed)", flush=True)
                runs[run] = rec
                if serve and graphs:
                    kept["graphed"] = trainer
                elif serve:
                    kept.setdefault("eager", trainer)
                del trainer
                torch.cuda.empty_cache()
        finally:
            if one_rank:
                ddp.shutdown()
        e, e2, g = (runs[k] for k in ("eager", "eager2", "graphed"))
        record = {
            "stats": spread_check(label, "stats", e["stats"], e2["stats"],
                                  g["stats"], "max"),
            "params": spread_check(label, "parameters", e["params"],
                                   e2["params"], g["params"], "l2"),
            "graph_calls": g["graph_calls"],
        }
        if one_rank:
            record["eval_graph_calls"] = g["eval_graph_calls"]
        if any(g["masks"]):
            record["masks"] = masks_check(label, e["masks"], e2["masks"],
                                          g["masks"])
        elif name == "keypoints":
            raise AssertionError(f"{label}: no stochastic-depth mask drawn")
        for run, rec in (("eager", e), ("graphed", g)):
            record[run] = {key: rec[key] for key in (
                "median_step_ms", "busy", "peak_bytes", "launches",
                "step_ms")}
        snapshots.clear()
        if kept:
            ms_e, dets_e = serve_ms(kept["eager"].backend.module, None)
            ms_g, dets_g = serve_ms(kept["graphed"].backend.module,
                                    StepGraphs("cuda"))
            record["serve_batch1_ms"] = {"eager": ms_e, "graphed": ms_g}
            print(f"serving call, batch 1 at {TRAIN_SIZE} px with decode: "
                  f"eager {ms_e:.3f} ms, graphed {ms_g:.3f} ms", flush=True)
            if not all(bool(torch.isfinite(t).all()) for t in
                       (dets_e, dets_g)):
                raise AssertionError("non-finite served detections")
            graphed = kept["graphed"]
            kept.clear()
            if not graphed.maybe_degrade_dcn(PALLAS_MAX_SHIFT):
                raise AssertionError("the degrade did not switch")
            if len(graphed.step_graphs):
                raise AssertionError("the degrade left the graphs")
            captures = graphed.step_graphs.calls["captures"]
            ms, stats = timed_steps(graphed, data, 2, expect())
            if graphed.step_graphs.calls["captures"] != captures + 1:
                raise AssertionError("no capture after the degrade")
            if not all(bool(torch.isfinite(s).all()) for s in stats):
                raise AssertionError("non-finite stats after the degrade")
            print(f"degrade: 2 steps on the exact op, a new capture, no "
                  f"launch, {' '.join(f'{t:.1f}' for t in ms)} ms",
                  flush=True)
            record["degrade_step_ms"] = ms
            del graphed
        out[label] = record
        runs.clear()
        torch.cuda.empty_cache()
    return out


def graphed_eval(trainer, data):
    """Two eval steps of a graphed trainer on ``data``: the first eager,
    the second captured and replayed, with finite stats that agree (the
    same weights on the same batch, within STAT_RTOL). Returns the two
    steps' graph calls."""
    import torch

    before = dict(trainer.step_graphs.calls)
    stats = [trainer.step(data, is_training=False)["stats"]
             for _ in range(2)]
    calls = {k: n - before[k] for k, n in trainer.step_graphs.calls.items()}
    if calls != {"eager": 1, "captures": 1, "replays": 1}:
        raise AssertionError(f"eval graph calls {calls}")
    a, b = (torch.stack([s[k].float() for k in sorted(s)]) for s in stats)
    if not (bool(torch.isfinite(b).all())
            and bool(torch.allclose(a, b, rtol=STAT_RTOL, atol=0.0))):
        raise AssertionError(f"eval stats eager {a} against graphed {b}")
    return calls


def masks_check(label, eager, eager2, graphed):
    """Every step's stochastic-depth masks, graphed against eager (and the
    second eager run against the first), bit for bit; returns the count of
    steps and of masks a step and the share of samples kept."""
    import torch

    for other, run in ((eager2, "eager2"), (graphed, "graphed")):
        for i, (a, b) in enumerate(zip(eager, other)):
            if len(a) != len(b) or not all(torch.equal(x, y)
                                           for x, y in zip(a, b)):
                raise AssertionError(f"{label}: {run}'s step {i} masks "
                                     "differ from the eager step's")
    kept = torch.cat([m.flatten().float() for ms in eager for m in ms])
    record = {"steps": len(eager), "masks_a_step": len(eager[0]),
              "kept": float(kept.mean())}
    print(f"{label}: stochastic-depth masks of {record['steps']} steps "
          f"({record['masks_a_step']} blocks a step), graphed and eager bit "
          f"for bit, {record['kept']:.1%} of samples kept", flush=True)
    return record


def kernel_line(name, src, replaces, outs, records, label, launches,
                dtype=None):
    """One entry of the ``kernels`` JSON line: times, bound and yardstick
    summed over the layers of one step of the ``label`` path (weighted by
    the layer count of each shape; ``dtype`` picks one precision's
    records); the error is the largest over every record of the kernel."""
    pre = "bwd" if name.endswith("bwd") else "fwd"
    recs = [r for r in records if r["path"] == label
            and (dtype is None or r.get("dtype") == dtype)]
    if not recs:
        raise AssertionError(f"{name}: no record of the {label} path")

    def per_step(key):
        return sum(r[key] * r["layers"] for r in recs)

    by_kind = {}
    for r in recs:
        kind = r[f"{pre}_bound_by"]
        by_kind[kind] = by_kind.get(kind, 0.0) + (
            r[f"{pre}_bound_ms"] * r["layers"])
    return {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"][o] for r in records
                           for o in outs),
        "ms": per_step(f"{pre}_ms"),
        "plain_ms": per_step(f"twin_{pre}_ms"),
        "bound_ms": per_step(f"{pre}_bound_ms"),
        "bound_by": max(by_kind, key=by_kind.get),
        "library_ms": per_step(f"conv_{pre}_ms"),
    }


def forced_lanes_eval(cfg, device):
    """Phase 6: DLA-34 (float32) evaluates WIDE_SIZE px under
    ``set_kernel_version("lanes")``: the layers wider than 256 px launch
    the wide forward, the rest the f32 forward, nothing else. Restores
    "auto". Returns the phase's record."""
    import numpy as np
    import torch

    from centernet_uda_torch.ops import dcn, dcn_cuda
    from centernet_uda_torch.train import build_trainer

    trainer = build_trainer(cfg, device="cuda")
    trainer.init_done()
    net = trainer.backend.module
    dcn.set_kernel_version("lanes")
    try:
        shapes = dcn_shapes(net, WIDE_SIZE, device)
        n_wide = sum(n for k, n in shapes.items()
                     if k[3] > dcn.LANES_NATIVE_MAX_W)
        n_lanes = sum(shapes.values()) - n_wide
        if not n_wide:
            raise AssertionError(f"no DCN layer wider than "
                                 f"{dcn.LANES_NATIVE_MAX_W} at {WIDE_SIZE}")
        data = synthetic_batch(np.random.RandomState(5), WIDE_BATCH,
                               WIDE_SIZE, int(cfg.model.backend.params
                                              .num_classes),
                               int(cfg.max_detections))
        torch.cuda.synchronize()
        dcn_cuda.reset_launches()
        t0 = time.perf_counter()
        outputs = trainer.step(data, is_training=False)
        dets = trainer.get_detections(outputs, data)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(dcn_cuda.LAUNCHES)
    finally:
        dcn.set_kernel_version("auto")
    want = expect(dcn_wide_fwd=n_wide, dcn_fwd=n_lanes)
    if launches != want:
        raise AssertionError(f"forced-lanes launches {launches} != {want}")
    vals = {k: float(v) for k, v in outputs["stats"].items()}
    boxes = dets["pred_boxes"]
    if boxes.shape != (WIDE_BATCH, int(cfg.max_detections), 4) or not (
            np.isfinite(boxes).all()
            and all(math.isfinite(v) for v in vals.values())):
        raise AssertionError(f"forced-lanes eval: boxes {boxes.shape}, "
                             f"stats {vals}")
    print(f"forced lanes eval {WIDE_SIZE}px B={WIDE_BATCH}: {ms:.1f} ms, "
          f"DCN shapes {shapes}, launches {launches}", flush=True)
    return {"ms": ms, "stats": vals, "launches": launches,
            "shapes": {str(k): n for k, n in shapes.items()}}


def write_coco_set(root, n_images, rng, num_classes, rotated=False,
                   num_kps=0):
    """``n_images`` binary PPM images of ``CLI_IMAGE_WH`` in ``root/images``
    and their COCO annotations in ``root/instances.json``: noise, and 5-29
    boxes per image drawn as ``synthetic_batch`` draws them (in image
    pixels, at least 8 px a side), each painted in its class's colour;
    with ``rotated`` each box also has an ``rbbox`` (its center and size
    and an angle in [-80, 80] degrees), with ``num_kps`` that many visible
    keypoints inside it. Returns (image folder, annotation file)."""
    import numpy as np

    from centernet_uda_torch.data.coco import write_ppm

    w, h = CLI_IMAGE_WH
    img_dir = root / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    images, anns = [], []
    for image_id in range(1, n_images + 1):
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        n = rng.randint(5, 30)
        xy = rng.rand(n, 2) * (w, h) * 0.85
        x2y2 = np.minimum(xy + rng.rand(n, 2) * (w, h) * 0.25 + 8.0,
                          (w - 1, h - 1))
        for (x1, y1), (x2, y2), c in zip(xy, x2y2,
                                         rng.randint(0, num_classes, n)):
            img[int(y1):int(y2), int(x1):int(x2)] = (
                60 * (c + 1) % 256, 40 * c, 200 - 30 * c)
            ann = {"id": len(anns) + 1, "image_id": image_id,
                   "category_id": int(c) + 1,
                   "bbox": [float(x1), float(y1), float(x2 - x1),
                            float(y2 - y1)],
                   "area": float((x2 - x1) * (y2 - y1)), "iscrowd": 0}
            if rotated:
                ann["rbbox"] = [float(x1 + x2) / 2, float(y1 + y2) / 2,
                                float(x2 - x1), float(y2 - y1),
                                float(rng.uniform(-80, 80))]
            if num_kps:
                pts = rng.rand(num_kps, 2) * (x2 - x1, y2 - y1) + (x1, y1)
                ann["keypoints"] = [float(v) for x, y in pts
                                    for v in (x, y, 2)]
                ann["num_keypoints"] = num_kps
            anns.append(ann)
        name = f"{image_id:05d}.ppm"
        write_ppm(img_dir / name, img)
        images.append({"id": image_id, "file_name": name, "width": w,
                       "height": h})
    anno = root / "instances.json"
    anno.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": c + 1, "name": f"class_{c + 1}"}
                       for c in range(num_classes)]}))
    return img_dir, anno


def memcpy_ms(trace_path, steps):
    """Device ms per step of each kind of memory copy in a torch.profiler
    chrome trace."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    out = {}
    for ev in events:
        if ev.get("cat") == "gpu_memcpy":
            out[ev["name"]] = out.get(ev["name"], 0.0) + ev["dur"] / 1e3
    return {k: v / steps for k, v in out.items()}


def run_cli(name, overrides, per_train, per_eval, profile_steps=0,
            native_used=NATIVE_FUNCTIONS, visualizations=CLI_VISUALIZATIONS):
    """Phase 7, one ``main()`` of the port's CLI on the card, run from
    ``CLI_DIR / name``. Each training step must launch ``per_train``, each
    eval step ``per_eval`` (counted from the CLI's phase records), every
    phase's loss and every ``MSCOCO_Precision``/``MSCOCO_Recall`` mean be
    finite. The host library's functions ``native_used`` must each have
    been called, and with ``native_used=()`` the run goes without the
    library (``CENTERNET_DISABLE_NATIVE``) and calls none. An eval phase
    writes ``visualizations`` detection images to TensorBoard (None: the
    config's number). Returns the
    run's record, with the messages of the checkpoint, TensorBoard and
    trainer loggers (``log``) and the library's call counts."""
    import logging
    import os

    import torch

    from centernet_uda_torch import native, train
    from centernet_uda_torch.ops import dcn_cuda

    workdir = CLI_DIR / name
    workdir.mkdir(parents=True, exist_ok=True)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    loggers = [logging.getLogger(n) for n in (
        "centernet_uda_torch.utils.checkpoint",
        "centernet_uda_torch.utils.tensorboard", "uda")]
    for logger in loggers:
        logger.setLevel(logging.INFO)
        logger.addHandler(handler)
    cwd = os.getcwd()
    os.chdir(workdir)
    if not native_used:
        os.environ[native.DISABLE_ENV] = "1"
    phases = []
    torch.cuda.synchronize()
    dcn_cuda.reset_launches()
    native.reset_calls()
    t0 = time.perf_counter()
    try:
        images = ([] if visualizations is None else
                  [f"tensorboard.num_visualizations={visualizations}"])
        scalars = train.main(overrides + images
                             + [f"profile_steps={profile_steps}"],
                             phases=phases)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        os.environ.pop(native.DISABLE_ENV, None)
        for logger in loggers:
            logger.removeHandler(handler)
    wall_s = time.perf_counter() - t0
    launches = dict(dcn_cuda.LAUNCHES)
    native_calls = dict(native.CALLS)
    if (any(native_calls[f] <= 0 for f in native_used)
            or not native_used and any(native_calls.values())):
        raise AssertionError(f"CLI {name}: host library calls "
                             f"{native_calls}, expected {native_used}")
    steps = {tag: sum(p["steps"] for p in phases if p["tag"] == tag)
             for tag in ("training", "validation")}
    want = {k: per_train[k] * steps["training"]
            + per_eval[k] * steps["validation"] for k in launches}
    if launches != want:
        raise AssertionError(f"CLI {name}: launches {launches} != {want} "
                             f"for {steps} steps")
    if not all(math.isfinite(p["total_loss"]) for p in phases):
        raise AssertionError(f"CLI {name}: non-finite loss in {phases}")
    coco = {k: v for k, v in scalars.items() if k.startswith("MSCOCO_")}
    means = {k: v for k, v in coco.items()
             if k.startswith(("MSCOCO_Precision/", "MSCOCO_Recall/"))}
    if len(means) != 12 or not all(map(math.isfinite, means.values())):
        raise AssertionError(f"CLI {name}: COCO means {means}")
    for p in phases:
        if p["tag"] == "training":
            print(f"CLI {name} epoch {p['epoch']}: train {p['steps']} steps "
                  f"in {p['seconds']:.2f} s, waiting for the loader "
                  f"{p['loader_wait_s'] / p['seconds']:.1%}, loss "
                  f"{p['total_loss']:.4f}", flush=True)
        else:
            print(f"CLI {name} epoch {p['epoch']}: eval {p['steps']} steps "
                  f"in {p['seconds']:.2f} s (detection images "
                  f"{p['log_detections_s']:.2f} s) + evaluator "
                  f"{p['evaluate_s']:.2f} s (loader wait "
                  f"{p['loader_wait_s'] / p['seconds']:.1%}), loss "
                  f"{p['total_loss']:.4f}", flush=True)
    print(f"CLI {name}: main() {wall_s:.1f} s, launches {launches}, mAP "
          f"{means['MSCOCO_Precision/mAP']:.5f}, mAR@100 "
          f"{means['MSCOCO_Recall/mAR100']:.5f}, host library calls "
          f"{native_calls}", flush=True)
    run = {"wall_s": wall_s, "phases": phases, "launches": launches,
           "coco": coco, "log": [r.getMessage() for r in records],
           "native_calls": native_calls}
    if profile_steps:
        run["memcpy_ms_per_step"] = memcpy_ms(
            workdir / "outputs" / "baseline" / "profile" / "trace.json",
            profile_steps)
        print(f"CLI {name}: copies per train step (device ms) "
              f"{run['memcpy_ms_per_step']}", flush=True)
    return run


def cli_data(seed):
    """The overrides that point a CLI run at phase 7's COCO set."""
    train_dir, val_dir = (CLI_DIR / "data" / part for part in ("train",
                                                               "val"))
    return [f"seed={seed}", "num_workers=4",
            f"datasets.training.params.image_folder={train_dir / 'images'}",
            f"datasets.training.params.annotation_file="
            f"{train_dir / 'instances.json'}",
            f"datasets.validation.params.image_folder={val_dir / 'images'}",
            f"datasets.validation.params.annotation_file="
            f"{val_dir / 'instances.json'}"]


def cli_target_domain():
    """The target-domain overrides of a UDA run on phase 7's set: its
    validation images, in both phases."""
    val_images = CLI_DIR / "data" / "val" / "images"
    return [f"datasets.{p}.params.target_domain_glob={val_images}/*.ppm"
            for p in ("training", "validation")]


def cli_on_data(n_dcn, seed, profile):
    """Phase 7: the port's CLI, ``experiment=baseline`` at full width, on a
    synthetic COCO set of PPM images: 2 epochs at float32, a resume to
    epoch 3, 1 epoch at bfloat16; then
    ``experiment=adversarial_entropy_minimization`` at float32 for 1 epoch
    and a resume to epoch 2 (both optimizers). Returns the phase's
    record."""
    import numpy as np

    rng = np.random.RandomState(seed)
    t0 = time.perf_counter()
    write_coco_set(CLI_DIR / "data" / "train", CLI_TRAIN_IMAGES, rng, 6)
    write_coco_set(CLI_DIR / "data" / "val", CLI_VAL_IMAGES, rng, 6)
    print(f"wrote {CLI_TRAIN_IMAGES} + {CLI_VAL_IMAGES} PPM images of "
          f"{CLI_IMAGE_WH} in {time.perf_counter() - t0:.1f} s", flush=True)
    sets = cli_data(seed)
    common = ["experiment=baseline", "batch_size=16"] + sets
    f32 = (expect(dcn_fwd=n_dcn, dcn_bwd=n_dcn), expect(dcn_fwd=n_dcn))
    out = {"cli_f32": run_cli("f32", common + ["epochs=2",
                                               "precision=float32"],
                              *f32, profile_steps=2 if profile else 0,
                              visualizations=None)}
    run_dir = CLI_DIR / "f32" / "outputs" / "baseline"
    written = sorted(p.name for p in run_dir.iterdir())
    if not {"config.yaml", "model_last.ckpt", "model_best.ckpt"} <= set(
            written):
        raise AssertionError(f"CLI run dir holds {written}")
    out["cli_resume"] = run_cli(
        "f32", common + ["epochs=3", "precision=float32",
                         f"resume={run_dir / 'model_last.ckpt'}"], *f32)
    epochs = [(p["epoch"], p["tag"]) for p in out["cli_resume"]["phases"]]
    if (epochs != [(3, "training"), (3, "validation")]
            or "restore optimizer state at epoch 2"
            not in out["cli_resume"]["log"]):
        raise AssertionError(f"resume ran {epochs}, logged "
                             f"{out['cli_resume']['log']}")
    out["cli_bf16"] = run_cli(
        "bf16", common + ["epochs=1", "precision=bfloat16"],
        expect(dcn_fused_fwd=n_dcn, dcn_fused_bwd=n_dcn),
        expect(dcn_fused_fwd=n_dcn))
    out.update(cli_host_paths(run_dir, common, f32, out["cli_f32"], seed))
    out.update(cli_other_backbones(sets))

    # ADVENT at its own batch (8), the validation images as the target
    # domain of both phases: an epoch, then a resume of both optimizers
    advent = ["experiment=adversarial_entropy_minimization",
              "precision=float32"] + sets + cli_target_domain()
    per_step = (expect(dcn_fwd=2 * n_dcn, dcn_bwd=2 * n_dcn),
                expect(dcn_fwd=2 * n_dcn))
    out["cli_advent"] = run_cli("advent", advent + ["epochs=1"], *per_step)
    adv_dir = CLI_DIR / "advent" / "outputs" / \
        "adversarial_entropy_minimization"
    written = {p.name for p in adv_dir.iterdir()}
    if not {"model_last.ckpt", "discriminator.ckpt"} <= written:
        raise AssertionError(f"ADVENT run dir holds {sorted(written)}")
    out["cli_advent_resume"] = run_cli(
        "advent", advent + ["epochs=2",
                            f"resume={adv_dir / 'model_last.ckpt'}"],
        *per_step)
    epochs = [(p["epoch"], p["tag"])
              for p in out["cli_advent_resume"]["phases"]]
    restored = out["cli_advent_resume"]["log"].count(
        "restore optimizer state at epoch 1")
    if epochs != [(2, "training"), (2, "validation")] or restored != 2:
        raise AssertionError(f"ADVENT resume ran {epochs}, restored "
                             f"{restored} optimizers")
    out["cli_coco_merged"] = coco_merged_on_data(rng, sets[:2])
    return out


def event_scalar_tags(log_dir):
    """The scalar tags of the TensorBoard event files in ``log_dir``."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    events = EventAccumulator(str(log_dir))
    events.Reload()
    return sorted(events.Tags()["scalars"])


def evaluator_ab(seed, images=CLI_VAL_IMAGES, num_classes=6,
                 per_image=150, turns=3):
    """Phase 7: the COCO evaluator alone, host library and numpy in turns
    in this process, on seeded detections the size of the CLI's eval (its
    images, 5-29 ground truths each, ``per_image`` detections, every other
    one near a ground truth). Returns the seconds of each evaluation, per
    matcher."""
    import os

    import numpy as np

    from centernet_uda_torch import native
    from centernet_uda_torch.evaluation.coco_eval_np import COCOEval

    rng = np.random.RandomState(seed)
    w, h = CLI_IMAGE_WH
    gts, dts = [], []
    for image_id in range(images):
        near = []
        for _ in range(rng.randint(5, 30)):
            x, y = rng.rand(2) * (w, h) * 0.85
            bw, bh = 8 + rng.rand(2) * (w, h) * 0.25
            near.append([x, y, x + bw, y + bh])
            gts.append({"image_id": image_id, "bbox": near[-1],
                        "category_id": int(rng.randint(1, num_classes + 1)),
                        "area": float(bw * bh), "iscrowd": 0})
        for k in range(per_image):
            if k % 2 == 0:
                box = (np.array(near[rng.randint(len(near))])
                       + rng.randn(4) * 6).tolist()
            else:
                x, y = rng.rand(2) * (w, h) * 0.85
                bw, bh = 8 + rng.rand(2) * (w, h) * 0.25
                box = [x, y, x + bw, y + bh]
            dts.append({"image_id": image_id, "bbox": box,
                        "category_id": int(rng.randint(1, num_classes + 1)),
                        "area": float((box[2] - box[0]) * (box[3] - box[1])),
                        "score": float(rng.rand())})
    out = {"host library": [], "numpy": []}
    try:
        for _ in range(turns):
            for key in out:
                if key == "numpy":
                    os.environ[native.DISABLE_ENV] = "1"
                t0 = time.perf_counter()
                COCOEval(gts, dts).evaluate_and_accumulate()
                out[key].append(time.perf_counter() - t0)
                os.environ.pop(native.DISABLE_ENV, None)
    finally:
        os.environ.pop(native.DISABLE_ENV, None)
    return out


def cli_host_paths(run_dir, common, f32, first, seed):
    """Phase 7, the host paths of the f32 DLA-34 run ``first`` (its
    record) in ``run_dir``: its
    TensorBoard event file (``MSCOCO_*`` among its scalars); the same 2
    epochs without the host library, each epoch's loader-wait share beside
    the library's, and each eval phase's seconds, its detection images'
    and its evaluator's side by side, then the evaluator alone in turns
    (``evaluator_ab``); ``model_last.ckpt`` with every key under
    DataParallel's ``module.`` prefix as ``pretrained``, every weight
    restored. Returns the records."""
    import re

    import torch

    out = {}
    writer = [m for m in first["log"]
              if m.startswith("TensorBoard logs in")]
    tags = event_scalar_tags(run_dir / "logs")
    print(f"event file: {writer}, {len(tags)} scalar tags, e.g. "
          f"{[t for t in tags if t.startswith('MSCOCO_')][:3]}", flush=True)
    if (not writer or "MSCOCO_Precision/mAP" not in tags
            or "training/total_loss" not in tags):
        raise AssertionError(f"event file: {writer}, tags {tags}")
    out["event_tags"] = tags

    out["cli_f32_numpy"] = run_cli(
        "f32_numpy", common + ["epochs=2", "precision=float32"], *f32,
        native_used=(), visualizations=None)
    shares = {key: [p["loader_wait_s"] / p["seconds"]
                    for p in run["phases"] if p["tag"] == "training"]
              for key, run in (("cli_f32", first),
                               ("cli_f32_numpy", out["cli_f32_numpy"]))}
    print(f"DLA-34 f32 loader wait a training epoch (4 threads): host "
          f"library {[f'{v:.1%}' for v in shares['cli_f32']]}, numpy "
          f"{[f'{v:.1%}' for v in shares['cli_f32_numpy']]}", flush=True)
    out["loader_wait_share"] = shares
    evals = {key: [{k: p[k] for k in ("seconds", "log_detections_s",
                                      "evaluate_s")}
                   for p in run["phases"] if p["tag"] == "validation"]
             for key, run in (("cli_f32", first),
                              ("cli_f32_numpy", out["cli_f32_numpy"]))}
    print("DLA-34 f32 eval phases, s (phase / of it detection images / "
          "evaluator after it): host library " + ", ".join(
              f"{p['seconds']:.3f}/{p['log_detections_s']:.3f}/"
              f"{p['evaluate_s']:.3f}" for p in evals["cli_f32"])
          + "; numpy " + ", ".join(
              f"{p['seconds']:.3f}/{p['log_detections_s']:.3f}/"
              f"{p['evaluate_s']:.3f}" for p in evals["cli_f32_numpy"]),
          flush=True)
    out["eval_phases"] = evals
    out["evaluator_ab_s"] = evaluator_ab(seed)
    print("COCO evaluator alone, in turns in one process (16 images, 150 "
          "detections each), s: " + "; ".join(
              f"{k} {[round(v, 4) for v in t]}"
              for k, t in out["evaluator_ab_s"].items()), flush=True)

    state = torch.load(run_dir / "model_last.ckpt", map_location="cpu",
                       weights_only=True)
    prefixed = CLI_DIR / "data" / "module_prefixed.ckpt"
    torch.save({"epoch": state["epoch"],
                "state_dict": {f"module.{k}": v
                               for k, v in state["state_dict"].items()}},
               prefixed)
    out["cli_prefixed"] = run_cli(
        "prefixed", common + ["epochs=1", "precision=float32",
                              f"pretrained={prefixed}"], *f32)
    n = len(state["state_dict"])
    restored = [m for m in out["cli_prefixed"]["log"]
                if re.fullmatch(rf"restored {n} of {n} weights from "
                                rf"{re.escape(str(prefixed))}", m)]
    if not restored:
        raise AssertionError(f"module.-prefixed checkpoint: "
                             f"{out['cli_prefixed']['log']}")
    print(f"module.-prefixed checkpoint as pretrained: {restored[0]}",
          flush=True)
    print("JAX-package checkpoints: not driven on the card: "
          "this host has no JAX to write one; on the CPU tests/"
          "test_torch_checkpoint.py::test_jax_checkpoint_through_main_and_"
          "export loads one through main(), load_model and the export CLI "
          "in a process without JAX", flush=True)
    return out


def cli_other_backbones(sets):
    """Phase 7: ``experiment=baseline_mobilenet_v2`` with ``use_dcn=true``
    (batch 32: a train step launches ``dcn_sel_fwd``/``dcn_sel_bwd`` once
    and ``dcn_fwd``/``dcn_bwd`` twice, an eval step the forwards) and
    ``experiment=baseline_resnet18`` (no DCN layer) through ``main()`` for
    one float32 epoch each. Returns the records."""
    return {
        "cli_mnv2": run_cli(
            "mnv2", ["experiment=baseline_mobilenet_v2",
                     "model.backend.params.use_dcn=true", "epochs=1",
                     "precision=float32"] + sets,
            expect(dcn_sel_fwd=1, dcn_sel_bwd=1, dcn_fwd=2, dcn_bwd=2),
            expect(dcn_sel_fwd=1, dcn_fwd=2)),
        "cli_resnet18": run_cli(
            "resnet18", ["experiment=baseline_resnet18", "epochs=1",
                         "precision=float32"] + sets, expect(), expect()),
    }


def coco_merged_on_data(rng, sets):
    """Phase 7's last run: ``experiment=coco_merged`` (EfficientNet-b3,
    rotated boxes, 5 keypoints) through ``main()`` for one float32 epoch on
    two source folders and a validation folder whose annotations have
    rotated boxes and keypoints. The training datasets are given as one
    YAML list (a dotted override cannot index into a list), each with the
    experiment's own augmentation. EfficientNet has no DCN layer: no
    launch."""
    import yaml

    root = CLI_DIR / "data" / "merged"
    sources = [write_coco_set(root / name, MERGED_IMAGES, rng, 6, True,
                              NUM_KPS) for name in ("source_a", "source_b")]
    val_dir, val_anno = write_coco_set(root / "target", MERGED_IMAGES, rng,
                                       6, True, NUM_KPS)
    exp = yaml.safe_load((ROOT / "configs" / "experiment" /
                          "coco_merged.yaml").read_text())
    augmentation = exp["datasets"]["training"]["params"]["datasets"][0][
        "params"]["augmentation"]
    merged = [{"name": "coco", "params": {
        "image_folder": str(img_dir), "annotation_file": str(anno),
        "augmentation": augmentation}} for img_dir, anno in sources]
    overrides = ["experiment=coco_merged", "precision=float32", "epochs=1",
                 *sets, "datasets.training.params.datasets="
                 + yaml.safe_dump(merged, default_flow_style=True,
                                  width=1 << 20).strip(),
                 f"datasets.validation.params.image_folder={val_dir}",
                 f"datasets.validation.params.annotation_file={val_anno}"]
    # rotated boxes keep their numpy encoder, as in the JAX package
    run = run_cli("coco_merged", overrides, expect(), expect(),
                  native_used=("normalize_image", "coco_greedy_match"))
    state = torch_load(CLI_DIR / "coco_merged" / "outputs" / "coco_merged"
                       / "model_last.ckpt")["state_dict"]
    if (state["wh.2.weight"].shape[0] != 3
            or state["kps.2.weight"].shape[0] != 2 * NUM_KPS):
        raise AssertionError("coco_merged checkpoint without rotated and "
                             "keypoint heads")
    return run


def torch_load(path):
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def with_target_domain(data, rng):
    """``data`` with a ``target_domain_input`` drawn with another mean and
    contrast than its source images."""
    return {**data, "target_domain_input": (
        rng.randn(*data["input"].shape) * 0.6 + 0.5).astype("float32")}


def check_fda_mix(trainer, data):
    """The trainer's FDA mix on the card against the same function on the
    CPU, within 1e-4 of the image scale; the mix must move the image."""
    import torch

    from centernet_uda_torch.ops.fda import fda_source_to_target

    src = torch.from_numpy(data["input"])
    tgt = torch.from_numpy(data["target_domain_input"])
    want = fda_source_to_target(src, tgt, trainer.beta, trainer.use_circular)
    got = fda_source_to_target(src.cuda(), tgt.cuda(), trainer.beta,
                               trainer.use_circular).cpu()
    scale = float(src.abs().max())
    err = float((got - want).abs().max())
    moved = float((want - src).abs().max())
    if not (err <= 1e-4 * scale and moved > 1e-2 * scale):
        raise AssertionError(f"FDA mix: card vs CPU {err}, moved {moved}, "
                             f"scale {scale}")
    print(f"FDA mix (beta {trainer.beta}, circular {trainer.use_circular}): "
          f"card vs CPU max |err| {err:.3g} of scale {scale:.3g}, moves the "
          f"image by {moved:.3g}", flush=True)
    return err


def disc_moved_each_step(trainer):
    """An ``after_step`` for ADVENT that fails unless every train step
    changes every discriminator parameter tensor."""
    import torch

    def snapshot():
        return [p.detach().clone() for p in trainer.discriminator.parameters()]

    last = snapshot()

    def check(_):
        now = snapshot()
        if any(torch.equal(a, b) for a, b in zip(now, last)):
            raise AssertionError("a discriminator parameter did not move in "
                                 "a train step")
        last[:] = now

    return check


def uda_trainers(n_dcn, seed, profile):
    """Phase 8: each UDA experiment at full width and its own batch takes
    UDA_STEPS train steps at TRAIN_SIZE on a seeded synthetic batch with a
    target domain, then one eval step at EVAL_SIZE with decode, at float32
    and, for UDA_BF16, at bfloat16. Each train step runs DLA-34 on both
    domains: 2 x 16 forward and 2 x 16 backward launches of its precision;
    an eval step 2 x 16 forwards. Returns {run name: record}."""
    import numpy as np
    import torch

    from centernet_uda_torch.config import compose
    from centernet_uda_torch.train import build_trainer

    out, batches = {}, {}
    for precision, fwd, bwd in (("float32", "dcn_fwd", "dcn_bwd"),
                                ("bfloat16", "dcn_fused_fwd",
                                 "dcn_fused_bwd")):
        for name in UDA_EXPERIMENTS:
            if precision == "bfloat16" and name not in UDA_BF16:
                continue
            phase(f"UDA {name} {precision}")
            cfg = compose([f"experiment={name}", f"seed={seed}",
                           f"precision={precision}"],
                          config_dir=str(ROOT / "configs"))
            batch = int(cfg.batch_size)
            if batch not in batches:
                rng = np.random.RandomState(seed + batch)
                batches[batch] = [with_target_domain(synthetic_batch(
                    rng, batch, size, int(cfg.model.backend.params
                                          .num_classes),
                    int(cfg.max_detections)), rng)
                    for size in (TRAIN_SIZE, EVAL_SIZE)]
            data, eval_data = batches[batch]
            trainer = build_trainer(cfg, device="cuda")
            trainer.init_done()
            key = f"uda_{name}" + ("_bf16" if precision == "bfloat16"
                                   else "")
            record = {"batch": batch}
            if name == "fda":
                record["fda_mix_max_abs_err"] = check_fda_mix(trainer, data)
            record["train"], record["eval"] = train_and_eval(
                trainer, cfg, data, eval_data,
                expect(**{fwd: 2 * n_dcn, bwd: 2 * n_dcn}),
                expect(**{fwd: 2 * n_dcn}), steps=UDA_STEPS,
                after_step=(disc_moved_each_step(trainer)
                            if name.startswith("adversarial") else None))
            later = record["train"]["step_ms"][1:]
            print(f"UDA {name} {precision} B={batch}: steps 2-{UDA_STEPS} "
                  f"{' '.join(f'{ms:.1f}' for ms in later)} ms, peak "
                  f"{record['train']['max_memory_allocated'] / 2**30:.2f} "
                  f"GiB", flush=True)
            if profile:
                record["profile"] = profile_train_steps(trainer, data)
            out[key] = record
            del trainer
            torch.cuda.empty_cache()
    return out


def check_heads_card_vs_cpu(trainer):
    """The backend's f32 heads on the card against the same module on the
    CPU: same weights, a 2 x 3 x 256 x 256 input, train-mode BatchNorm on
    copies (the trainer's statistics stay as they are), TF32 off. The CPU
    runs the module in float64, so the check reads the card's f32 rounding
    alone: within CARD_VS_CPU of each head's scale. The CPU's own f32 run
    against its float64 one is printed beside it. Returns {head: (max
    |err|, relative, the CPU f32's relative)}."""
    import copy

    import numpy as np
    import torch

    net = trainer.backend.module
    generator = getattr(net, "drop_generator", None)
    if generator is not None:
        net.drop_generator = None  # no stochastic depth in the comparison
    try:
        card = copy.deepcopy(net).train()
        cpu = copy.deepcopy(net).cpu().train()
    finally:
        if generator is not None:
            net.drop_generator = generator
    x = torch.from_numpy(np.random.RandomState(7).randn(
        2, 3, 256, 256).astype(np.float32))
    with torch.no_grad():
        got = {k: v.cpu() for k, v in card(x.cuda()).items()}
        del card
        cpu_f32 = cpu(x)
        for mod in cpu.double().modules():
            if hasattr(mod, "compute_dtype"):
                mod.compute_dtype = torch.float64
        want = cpu(x.double())
    errs = {}
    for k, w in want.items():
        scale = float(w.abs().max())
        err = float((got[k].double() - w).abs().max())
        cpu_err = float((cpu_f32[k].double() - w).abs().max())
        if not (bool(torch.isfinite(got[k]).all())
                and err <= CARD_VS_CPU * scale):
            raise AssertionError(f"head {k} on the card vs the CPU: max "
                                 f"|err| {err}, scale {scale}")
        errs[k] = (err, err / scale, cpu_err / scale)
    del cpu
    print(f"{trainer.backend.name} f32 heads on the card vs the CPU in "
          f"float64 (the CPU's f32 beside): " + " ".join(
              f"{k}={v[0]:.3g}/{v[1]:.2g} ({v[2]:.2g})"
              for k, v in errs.items()), flush=True)
    return errs


def backbones_rotated_keypoints(n_dcn, seed):
    """Phase 9: ResNet, EfficientNet, rotated boxes and keypoints, and
    ``freeze_base`` (runs a-e of the module docstring). Returns {run name:
    record}."""
    import numpy as np
    import torch

    from centernet_uda_torch.config import compose
    from centernet_uda_torch.train import build_trainer

    none = expect()
    f32_dcn = (expect(dcn_fwd=n_dcn, dcn_bwd=n_dcn), expect(dcn_fwd=n_dcn))
    bf16_dcn = (expect(dcn_fused_fwd=n_dcn, dcn_fused_bwd=n_dcn),
                expect(dcn_fused_fwd=n_dcn))
    dla_rk = ["experiment=baseline", "model.backend.params.rotated_boxes=true",
              f"model.backend.params.num_keypoints={NUM_KPS}",
              *COCO_MERGED_LOSS]
    runs = [
        ("rotated", ["experiment=rotated"], "float32", (none, none)),
        ("rotated_bf16", ["experiment=rotated"], "bfloat16", (none, none)),
        ("resnet18", ["experiment=baseline_resnet18"], "float32",
         (none, none)),
        ("resnet50", ["experiment=baseline_resnet50"], "float32",
         (none, none)),
        ("keypoints", ["experiment=keypoints", "gpu=null"], "float32",
         (none, none)),
        ("keypoints_bf16", ["experiment=keypoints", "gpu=null"], "bfloat16",
         (none, none)),
        ("dla_rotated_kps", dla_rk, "float32", f32_dcn),
        ("dla_rotated_kps_bf16", dla_rk, "bfloat16", bf16_dcn),
        ("dla_freeze_base", dla_rk + ["model.backend.params.freeze_base=true"],
         "float32", f32_dcn),
    ]
    out = {}
    for name, overrides, precision, (per_step, per_eval) in runs:
        phase(f"backbones, rotated boxes, keypoints: {name}")
        cfg = compose(overrides + [f"seed={seed}", f"precision={precision}"],
                      config_dir=str(ROOT / "configs"))
        trainer = build_trainer(cfg, device="cuda")
        trainer.init_done()
        backend = trainer.backend
        rng = np.random.RandomState(seed + len(out))
        batch = int(cfg.batch_size)
        data, eval_data = [synthetic_batch(
            rng, batch, size, backend.num_classes, int(cfg.max_detections),
            rotated=backend.rotated_boxes, num_kps=backend.num_keypoints)
            for size in (TRAIN_SIZE, EVAL_SIZE)]
        if trainer.requires_target_domain:
            data = with_target_domain(data, rng)
            eval_data = with_target_domain(eval_data, rng)
        record = {"batch": batch, "backend": backend.name,
                  "precision": precision}
        if name.startswith("dla"):
            record["heads_vs_exact_max_abs_err"] = check_heads_against_exact(
                trainer, torch.device("cuda"), bf16=precision == "bfloat16")
        elif precision == "float32":
            record["heads_card_vs_cpu"] = check_heads_card_vs_cpu(trainer)
        net = backend.module
        before = {k: p.detach().clone() for k, p in net.named_parameters()}
        train_calls = {}
        record["train"], record["eval"] = train_and_eval(
            trainer, cfg, data, eval_data, per_step, per_eval,
            steps=P9_STEPS,
            after_step=lambda t: train_calls.update(t.step_graphs.calls))
        if trainer.drop_generator is not None:
            if train_calls != {"eager": 1, "captures": 1,
                               "replays": P9_STEPS - 1}:
                raise AssertionError(f"{name}: train graph calls "
                                     f"{train_calls}")
            print(f"{name}: the train steps replayed their graph, the "
                  f"stochastic-depth generator registered: graph calls "
                  f"{train_calls}", flush=True)
        record["train_graph_calls"] = train_calls
        if name == "dla_freeze_base":
            for k, p in net.named_parameters():
                trunk = k.startswith("base.")
                if trunk != (not p.requires_grad):
                    raise AssertionError(f"{k}: requires_grad "
                                         f"{p.requires_grad}")
                if trunk and not torch.equal(p, before[k]):
                    raise AssertionError(f"frozen {k} moved")
                if (k.split(".")[0] in backend.heads
                        and torch.equal(p, before[k])):
                    raise AssertionError(f"head parameter {k} did not move")
            print("freeze_base: every trunk parameter bitwise unchanged, "
                  "every head parameter moved", flush=True)
        later = record["train"]["step_ms"][1:]
        print(f"{name} {backend.name} {precision} B={batch}: steps "
              f"2-{P9_STEPS} {' '.join(f'{ms:.1f}' for ms in later)} ms, "
              f"peak {record['train']['max_memory_allocated'] / 2**30:.2f} "
              f"GiB, eval {record['eval']['ms']:.1f} ms", flush=True)
        out[f"p9_{name}"] = record
        del trainer, net, before
        torch.cuda.empty_cache()
    return out


# phase 10: the serving artifacts of DLA-34 (name, input size, batch, with
# decode), exported from phase 7's float32 run
EXPORT_RUNS = (("dla34_512", 512, 1, True), ("dla34_800_wd", 800, 4, False))
# eager and artifact outputs: raw heads within SERVE_TOL of each head's
# scale, the (sorted) top-k scores within SERVE_TOL, and each top-k row's
# class and box alike to its partner's, the row of the other output with
# the same class and a score within that bound (rows at the top-k cut are
# left out: a few steps of training leave many of the top 100 at the
# heatmap's clamp, 1e-4, tied; a row whose peak has a neighbour within that
# bound in the eager heatmap may come from either pixel, since the decode's
# max-pool may keep either: a fresh process's 512 px artifact moved such a
# row by one output pixel, 4.0 px, with its scores 1.1e-6 from eager's, in
# a run on one H100; such a row's box is held against the eager heads' box
# at a pixel the pool may keep within the pool window of its partner's
# pixel). The DCN forward is not bitwise repeatable:
# where a grid is short it splits Cin across blocks that add with float
# atomics, and it stages x in bf16, so a last-bit change upstream can flip
# a rounding (two eager calls of DLA-34 at 800 px part by 1.1e-3 of the reg
# head's scale, measured on one H100; at 512 px, a pair of calls that agreed
# bitwise was followed by an artifact call 7e-7 off in the sorted scores
# that reordered near-equal rows). Where SPREAD_CALLS more eager calls on
# the same input part from the first by more than SERVE_TOL, the bound is
# SPREAD_FACTOR times their largest spread.
SERVE_TOL, SPREAD_FACTOR, SPREAD_CALLS = 1e-5, 4.0, 4
# the one-rank step against the plain step: the first step's losses within
# RANK_TOL of the largest loss, or SPREAD_FACTOR times the range of
# RANK_PLAIN plain trainers' first-step losses where that is larger (the
# DCN forward is not bitwise repeatable, see SERVE_TOL: two plain f32
# trainers' first losses on one batch parted by 3.3e-5 to 3.0e-4 of 18.7
# in runs on one H100; one pair is too few to bound a third sample)
RANK_TOL, RANK_PLAIN = 1e-5, 4
P10_STEPS = 3
BN_SYNC_GROUPS = (2, 4)
# DCNPooling at the deformable R-FCN's shape (the DCN paper's COCO
# detector: 81 classes, 7 x 7 groups and bins, 4 samples a bin, trans_std
# 0.1, fc layers 1024 wide) on the stride-16 map of a 512 px batch of 2,
# 64 RoIs an image; card against CPU within POOL_TOL of scale
POOL = dict(batch=2, size=32, output_dim=81, group=7, pooled=7,
            rois_per_image=64, spatial_scale=1 / 16, trans_std=0.1,
            fc_dim=1024)
POOL_TOL = 1e-4
SERVE_DIR = ROOT / "build" / "serve"

# the fresh process of phase 10: imports the port alone, loads each
# artifact with load_artifact, runs it on its saved input, saves the
# outputs and prints each artifact's launches and ms per call as JSON
SERVE_IN_FRESH_PROCESS = """
import json, sys
import numpy as np, torch
from centernet_uda_torch.export import load_artifact
from centernet_uda_torch.ops import dcn_cuda
report = {}
for job in json.loads(sys.argv[1]):
    program = load_artifact(job["path"]).module()
    x = torch.from_numpy(np.load(job["input"])).cuda()
    dcn_cuda.reset_launches()
    with torch.no_grad():
        out = program(x)
    torch.cuda.synchronize()
    launches = dict(dcn_cuda.LAUNCHES)
    torch.save(out, job["output"])
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.no_grad():
        start.record()
        for _ in range(10):
            program(x)
        end.record()
    torch.cuda.synchronize()
    report[job["name"]] = {"launches": launches,
                           "ms": start.elapsed_time(end) / 10}
report["foreign_modules"] = sorted(
    m for m in sys.modules if m.split(".")[0] in
    ("jax", "jaxlib", "flax", "optax", "centernet_uda_tpu"))
print(json.dumps(report))
"""


def eager_candidates(serving, x):
    """What the decode of the serving module ``serving`` may return on
    ``x``, pixel by pixel: the heatmap after the sigmoid (N, C, H, W) and
    each pixel's box in input pixels (N, H, W, 4), from the eager heads
    (axis-aligned boxes)."""
    import torch

    from centernet_uda_torch.ops.tensor import sigmoid_clamped

    heads = serving.net(x)
    hm = sigmoid_clamped(heads["hm"]).double().cpu()
    wh, reg = heads["wh"].double().cpu(), heads["reg"].double().cpu()
    n, _, h, w = hm.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64),
                            indexing="ij")
    cx, cy = xs + reg[:, 0], ys + reg[:, 1]
    boxes = torch.stack([cx - wh[:, 0] / 2, cy - wh[:, 1] / 2,
                         cx + wh[:, 0] / 2, cy + wh[:, 1] / 2], dim=-1)
    return hm, boxes * serving.down_ratio, serving.nms_size


def decoded_rows(out):
    """A decoded output ``(boxes, scores, classes[, keypoints])`` as
    (geometry, scores, classes) in float64 on the host, the geometry being
    the box with the keypoints appended where served."""
    import torch

    out = [t.double().cpu() for t in out]
    geometry = out[0] if len(out) == 3 else torch.cat(
        [out[0], out[3].flatten(2)], dim=-1)
    return geometry, out[1], out[2]


def decoded_diff(got, want, window, eager, box_bound=0.0):
    """Two decoded outputs ``(boxes, scores, classes[, keypoints])``: the
    largest difference of the sorted top-k scores, and row by row the
    geometry (box, and keypoints where served) against the nearest row of
    the other output with the same class and a score within ``window``,
    both ways. A row within ``window`` of its output's k-th score is left
    out (a near-tie across the cut may trade it for a row beyond the top
    k); every other row must find a partner. Sorted scores alone cannot
    say which rows may swap: a change of each score by ``d`` can move the
    sorted vector by far less than ``d``.

    A box row further than ``box_bound`` from its partners may come from
    the other pixel of a max-pool near-tie: it is held instead at a tie
    partner, if that is nearer. Its partner row ``j`` is located at the
    eager pixel ``q`` of its class, score within ``window``, whose box in
    the eager heads (``eager``: ``eager_candidates``) is nearest to ``j``'s;
    the row is then held against the eager box at the pixels of ``q``'s
    max-pool window that the pool may keep (a local maximum up to
    ``window``) with the row's class and a score within ``window``. Its
    error is the larger of ``q``'s and that one. Returns the score error,
    the largest geometry error, the rows checked, the rows with no
    partner, the rows held at a tie partner, the rows the partner check
    alone puts beyond ``box_bound``, and the geometry's scale."""
    import torch
    import torch.nn.functional as F

    hm, cand_boxes, size = eager
    r = size // 2
    keepable = hm >= F.max_pool2d(hm, size, 1, r) - window
    pixels = {}

    def pixel_of(side, out, n, j):
        """The eager pixel (y, x) that row ``j`` of image ``n`` of ``out``
        decodes and its box error there, or None."""
        key = (side, n, j)
        if key not in pixels:
            g, s, c = out
            level = (hm[n, int(c[n, j])] - s[n, j]).abs() <= window
            errs = (cand_boxes[n] - g[n, j]).abs().amax(dim=-1).masked_fill(
                ~level, float("inf"))
            k = int(errs.argmin())
            y, x = divmod(k, errs.shape[1])
            pixels[key] = ((y, x, float(errs[y, x])) if bool(level.any())
                           else None)
        return pixels[key]

    def at_tie_partner(a, b, side_b, n, i, partners):
        """Row ``i`` of ``a``'s error held at its tie partners in ``b``."""
        ga, sa, ca = a
        c = int(ca[n, i])
        allowed = keepable[n, c] & ((hm[n, c] - sa[n, i]).abs() <= window)
        best = float("inf")
        for j in partners.tolist():
            q = pixel_of(side_b, b, n, j)
            if q is None:
                continue
            y, x, q_err = q
            y0, x0 = max(y - r, 0), max(x - r, 0)
            near = allowed[y0:y + r + 1, x0:x + r + 1]
            if bool(near.any()):
                boxes = cand_boxes[n, y0:y + r + 1, x0:x + r + 1][near]
                best = min(best, max(q_err, float(
                    (boxes - ga[n, i]).abs().amax(dim=-1).min())))
        return best

    def one_way(a, b, side_b):
        """Each row of ``a`` clear of its cut against its partners in
        ``b``: (largest geometry error, rows checked, rows unmatched, rows
        held at a tie partner, rows beyond ``box_bound`` at a partner)."""
        (ga, sa, ca), (gb, sb, cb) = a, b
        err, checked, unmatched, at_tie, beyond = 0.0, 0, 0, 0, 0
        for n in range(sa.shape[0]):
            for i in torch.nonzero(sa[n] > sa[n, -1] + window).flatten():
                partner = (((sb[n] - sa[n, i]).abs() <= window)
                           & (cb[n] == ca[n, i]))
                checked += 1
                if not bool(partner.any()):
                    unmatched += 1
                    continue
                row = float((gb[n][partner] - ga[n, i])
                            .abs().amax(dim=-1).min())
                if row > box_bound:
                    beyond += 1
                    if ga.shape[-1] == 4:
                        tie = at_tie_partner(a, b, side_b, n, int(i),
                                             torch.nonzero(partner)
                                             .flatten())
                        if tie < row:
                            at_tie += 1
                            row = tie
                err = max(err, row)
        return err, checked, unmatched, at_tie, beyond

    a, b = decoded_rows(got), decoded_rows(want)
    score_err = float((a[1] - b[1]).abs().max())
    ab, ba = one_way(a, b, "want"), one_way(b, a, "got")
    return (score_err, max(ab[0], ba[0]), *(x + y for x, y in zip(
        ab[1:], ba[1:])), float(b[0].abs().max()))


def served_spread(first, others, eager=None):
    """The eager module's own spread over SPREAD_CALLS more calls on one
    input: per output (``served_errors``'s keys), the largest difference
    of ``others`` from ``first``; decoded rows are paired within SERVE_TOL
    of score, or SPREAD_FACTOR times the score spread where that is
    larger (``decoded_diff`` with the eager candidates ``eager``)."""
    if isinstance(first, dict):
        return {k: max(float((o[k].double() - v.double()).abs().max())
                       for o in others) for k, v in first.items()}
    scores = max(decoded_diff(o, first, SERVE_TOL, eager)[0]
                 for o in others)
    window = max(SERVE_TOL, SPREAD_FACTOR * scores)
    boxes = 0.0
    for o in others:
        _, err, _, unmatched, _, _, _ = decoded_diff(o, first, window, eager)
        if unmatched:
            raise AssertionError(f"eager serving module: {unmatched} top-k "
                                 "rows of one call have no partner in "
                                 "another call's")
        boxes = max(boxes, err)
    return {"scores": scores, "boxes": boxes}


def served_errors(name, got, want, spread, eager=None):
    """Artifact outputs against the eager serving module's: raw heads, or
    the sorted top-k scores and each top-k row's class and geometry
    against its partner's (``decoded_diff`` with the eager candidates
    ``eager``, the score window being the scores' bound), each within
    ``max(SERVE_TOL * scale, SPREAD_FACTOR * spread)`` (see SERVE_TOL).
    Returns {output: max |err|}."""
    import torch

    def bound(scale, key):
        return max(SERVE_TOL * scale, SPREAD_FACTOR * spread[key])

    if isinstance(want, dict):
        errs = {}
        for k, w in want.items():
            scale = float(w.abs().max())
            errs[k] = float((got[k].double() - w.double()).abs().max())
            if not (bool(torch.isfinite(got[k]).all())
                    and errs[k] <= bound(scale, k)):
                raise AssertionError(f"{name} head {k}: max |err| "
                                     f"{errs[k]}, scale {scale}, eager "
                                     f"spread {spread[k]}")
        return errs
    scale = float(decoded_rows(want)[0].abs().max())
    score_err, box_err, checked, unmatched, at_tie, beyond, _ = decoded_diff(
        got, want, bound(1.0, "scores"), eager, bound(scale, "boxes"))
    errs = {"scores": score_err, "boxes": box_err, "rows": checked,
            "rows_at_a_tie": at_tie, "rows_beyond_at_partner": beyond}
    if not (all(bool(torch.isfinite(t).all()) for t in got) and checked
            and not unmatched and score_err <= bound(1.0, "scores")
            and box_err <= bound(scale, "boxes")):
        raise AssertionError(f"{name}: {errs}, rows with no partner "
                             f"{unmatched}, eager spread {spread}")
    return errs


def serve_artifacts(n_dcn, seed):
    """Phase 10 a-b: export DLA-34 from phase 7's float32 checkpoint
    through the export CLI (512 px batch 1 with decode as ``.pt2`` and
    ``.opt.pt2``, 800 px batch 4 ``-wd`` as ``.pt2``) and MobileNetV2 with
    ``use_dcn`` from its seeded init (512 px, batch 1, with decode); reload
    each artifact with ``load_artifact`` in this process and in a fresh
    one that imports the port alone, run it on the card, and hold its
    launches and outputs against the eager serving module's. Returns the
    phase's record."""
    import os

    import numpy as np
    import torch

    from centernet_uda_torch import export
    from centernet_uda_torch import models as model_registry
    from centernet_uda_torch.config import compose
    from centernet_uda_torch.ops import dcn_cuda

    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    outputs = CLI_DIR / "f32" / "outputs"
    cfg = export.config_lib.load_composed(
        str(outputs / "baseline" / "config.yaml"))
    rng = np.random.RandomState(seed)
    served, jobs = {}, []

    def check_artifact(name, path, serving, x, per_call):
        """Reload one artifact here; its launches, outputs and ms beside
        the eager module's."""
        with torch.no_grad():
            want = serving(x)
            eager = (eager_candidates(serving, x) if serving.with_decode
                     else None)
            spread = served_spread(
                want, [serving(x) for _ in range(SPREAD_CALLS)], eager)
            eager_ms = time_ms(lambda: serving(x))
        program = export.load_artifact(path).module()
        dcn_cuda.reset_launches()
        with torch.no_grad():
            got = program(x)
        torch.cuda.synchronize()
        launches = dict(dcn_cuda.LAUNCHES)
        if launches != per_call:
            raise AssertionError(f"{name}: artifact launches {launches} != "
                                 f"{per_call}")
        errs = served_errors(name, got, want, spread, eager)
        with torch.no_grad():
            ms = time_ms(lambda: program(x))
        np.save(SERVE_DIR / f"{name}.in.npy", x.cpu().numpy())
        jobs.append({"name": name, "path": str(path),
                     "input": str(SERVE_DIR / f"{name}.in.npy"),
                     "output": str(SERVE_DIR / f"{name}.out.pt")})
        served[name] = {"launches": launches, "errs": errs, "ms": ms,
                        "eager_spread": spread, "eager_ms": eager_ms,
                        "want": want, "eager": eager, "per_call": per_call,
                        "bytes": path.stat().st_size}
        print(f"{name}: {path.name} ({path.stat().st_size / 2**20:.1f} MiB) "
              f"{ms:.3f} ms/call, eager {eager_ms:.3f} ms/call, launches "
              f"{ {k: v for k, v in launches.items() if v} }, max |err| "
              + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
              + " (eager's own spread " + " ".join(
                  f"{k}={v:.3g}" for k, v in spread.items()) + ")",
              flush=True)

    dla = expect(dcn_fwd=n_dcn)
    for name, size, batch, decode in EXPORT_RUNS:
        args = ["-e", "baseline", "-i", str(size), str(size), "-b",
                str(batch), "--outputs-dir", str(outputs), "--formats",
                "pt2", *(["opt"] if decode else ["-wd"])]
        t0 = time.perf_counter()
        paths = export.main(args)
        export_s = time.perf_counter() - t0
        print(f"{name}: export CLI {args} wrote "
              f"{[p.name for p in paths]} in {export_s:.1f} s", flush=True)
        serving = export.ServingModule(export.build_model(
            cfg, outputs / "baseline" / "model_last.ckpt", "cuda"),
            with_decode=decode)
        x = torch.from_numpy(rng.randn(batch, 3, size, size).astype(
            np.float32)).cuda()
        for path in paths:
            kind = "opt" if path.name.endswith(".opt.pt2") else "pt2"
            check_artifact(f"{name}_{kind}", path, serving, x, dla)
        served[f"{name}_pt2"]["export_s"] = export_s

    cfg_m = compose(["experiment=baseline_mobilenet_v2",
                     "model.backend.params.use_dcn=true", f"seed={seed}"],
                    config_dir=str(ROOT / "configs"))
    params = cfg_m.model.backend.params.to_dict()
    backend = model_registry.build(cfg_m.model.backend.name, **params,
                                   seed=seed, dtype=torch.float32,
                                   device="cuda")
    serving = export.ServingModule(backend)
    t0 = time.perf_counter()
    program = export.export_program(serving, (1, 3, TRAIN_SIZE, TRAIN_SIZE))
    path = export.export_pt2(program, SERVE_DIR / export.artifact_name(
        cfg_m, (TRAIN_SIZE, TRAIN_SIZE), True))
    print(f"mobilenetv2: exported {path.name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    x = torch.from_numpy(rng.randn(1, 3, TRAIN_SIZE, TRAIN_SIZE).astype(
        np.float32)).cuda()
    check_artifact("mobilenetv2_512_pt2", path, serving, x,
                   expect(dcn_sel_fwd=1, dcn_fwd=2))
    del backend, serving, program

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", SERVE_IN_FRESH_PROCESS, json.dumps(jobs)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    if proc.returncode != 0:
        raise AssertionError(f"fresh process failed:\n{proc.stderr[-4000:]}")
    fresh = json.loads(proc.stdout.strip().splitlines()[-1])
    if fresh.pop("foreign_modules"):
        raise AssertionError("the fresh process imported JAX or the JAX "
                             "package")
    for name, rec in served.items():
        if fresh[name]["launches"] != rec["per_call"]:
            raise AssertionError(f"{name} in a fresh process: launches "
                                 f"{fresh[name]['launches']}")
        got = torch.load(SERVE_DIR / f"{name}.out.pt", weights_only=True)
        rec["fresh_errs"] = served_errors(f"{name} (fresh)", got,
                                          rec.pop("want"),
                                          rec["eager_spread"],
                                          rec.pop("eager"))
        rec["fresh_ms"] = fresh[name]["ms"]
        print(f"{name} in a fresh process: {rec['fresh_ms']:.3f} ms/call, "
              f"launches as here, max |err| " + " ".join(
                  f"{k}={v:.3g}" for k, v in rec["fresh_errs"].items()),
              flush=True)
    print(f"fresh process: {time.perf_counter() - t0:.1f} s for "
          f"{len(jobs)} artifacts", flush=True)
    for rec in served.values():
        rec.pop("per_call")
    return served


def one_rank_steps(n_dcn, seed):
    """Phase 10 c, steps: DLA-34 at each precision takes P10_STEPS train
    steps on one seeded batch as a plain trainer, then as the trainer of a
    one-rank NCCL group (its normalizers, gradients and stats all-reduced):
    each step launches the precision's 16 + 16 kernels, and the first
    step's losses (same weights, same batch) equal the plain step's within
    RANK_TOL of the largest, or SPREAD_FACTOR times the range of RANK_PLAIN
    plain trainers' first steps where that is larger. Returns {precision:
    record}."""
    import numpy as np
    import torch

    from centernet_uda_torch.config import compose
    from centernet_uda_torch.ops import dcn_cuda
    from centernet_uda_torch.parallel import ddp
    from centernet_uda_torch.train import build_trainer

    out = {}
    for precision, fwd, bwd in (("float32", "dcn_fwd", "dcn_bwd"),
                                ("bfloat16", "dcn_fused_fwd",
                                 "dcn_fused_bwd")):
        cfg = compose(["experiment=baseline", f"precision={precision}",
                       f"seed={seed}"], config_dir=str(ROOT / "configs"))
        data = synthetic_batch(np.random.RandomState(seed),
                               int(cfg.batch_size), TRAIN_SIZE,
                               int(cfg.model.backend.params.num_classes),
                               int(cfg.max_detections))
        runs = {}
        modes = ["plain", "one_rank"] + [f"plain_{i}"
                                         for i in range(1, RANK_PLAIN)]
        for mode in modes:
            if mode == "one_rank":
                ddp.init(ddp.Ranks(0, 1, 0, 1, port=ddp.free_port()),
                         torch.device("cuda", 0))
            try:
                trainer = build_trainer(cfg, device="cuda")
                trainer.init_done()
                step_ms, losses = [], []
                dcn_cuda.reset_launches()
                steps = 1 if mode.startswith("plain_") else P10_STEPS
                for _ in range(steps):
                    t0 = time.perf_counter()
                    stats = trainer.step(data, is_training=True)["stats"]
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    losses.append({k: float(v) for k, v in stats.items()})
                launches = dict(dcn_cuda.LAUNCHES)
                distributed = ddp.is_distributed()
                graph_calls = dict(trainer.step_graphs.calls)
            finally:
                ddp.shutdown()
            want = expect(**{fwd: n_dcn * steps, bwd: n_dcn * steps})
            if launches != want or distributed != (mode == "one_rank"):
                raise AssertionError(f"{mode} {precision}: launches "
                                     f"{launches}, distributed "
                                     f"{distributed}")
            if not all(math.isfinite(v) for s in losses for v in s.values()):
                raise AssertionError(f"{mode} {precision}: losses {losses}")
            if mode == "one_rank" and graph_calls != {
                    "eager": 1, "captures": 1, "replays": P10_STEPS - 1}:
                raise AssertionError(f"one rank {precision}: graph calls "
                                     f"{graph_calls}")
            runs[mode] = {"step_ms": step_ms, "stats": losses,
                          "launches": launches, "graph_calls": graph_calls}
            del trainer
            torch.cuda.empty_cache()
        plain = runs["plain"]["stats"][0]
        first = {k: abs(runs["one_rank"]["stats"][0][k] - v)
                 for k, v in plain.items()}
        spread = max(
            max(runs[m]["stats"][0][k] for m in modes if m != "one_rank")
            - min(runs[m]["stats"][0][k] for m in modes if m != "one_rank")
            for k in plain)
        scale = max(abs(v) for v in plain.values())
        if max(first.values()) > max(RANK_TOL * scale,
                                     SPREAD_FACTOR * spread):
            raise AssertionError(f"{precision}: the one-rank step's losses "
                                 f"part from the plain step's: {first}, "
                                 f"{RANK_PLAIN} plain trainers by {spread}")
        later = [max(abs(a[k] - b[k]) for k in a) for a, b in zip(
            runs["plain"]["stats"][1:], runs["one_rank"]["stats"][1:])]
        ms = {m: sum(runs[m]["step_ms"][1:]) / (P10_STEPS - 1)
              for m in ("plain", "one_rank")}
        print(f"one NCCL rank, DLA-34 {precision} B={cfg.batch_size}: graph "
              f"calls {runs['one_rank']['graph_calls']} (the train step "
              f"graphed, its all-reduces captured); step "
              f"{ms['one_rank']:.1f} ms (plain {ms['plain']:.1f} ms); first "
              f"step's losses max |diff| {max(first.values()):.3g} of "
              f"{scale:.4g} ({RANK_PLAIN} plain trainers: {spread:.3g}); "
              f"later "
              f"steps' {['%.3g' % d for d in later]}", flush=True)
        out[precision] = {"runs": runs, "first_step_max_abs_diff":
                          max(first.values()), "plain_spread": spread,
                          "later_max_abs_diff": later, "step_ms": ms}
    return out


def grouped_bn_steps(n_dcn, seed):
    """Phase 10 d: DLA-34 at float32 with ``bn_sync`` 2 and 4 (statistics
    per group of 8 and 4 samples of the batch of 16): P10_STEPS train
    steps and an eval step, launches as in phase 4, losses finite. Returns
    {run name: record}."""
    import numpy as np
    import torch

    from centernet_uda_torch.config import compose
    from centernet_uda_torch.models.common import BatchNorm2d
    from centernet_uda_torch.train import build_trainer

    out = {}
    for groups in BN_SYNC_GROUPS:
        phase(f"bn_sync={groups}: DLA-34 float32")
        cfg = compose(["experiment=baseline", f"bn_sync={groups}",
                       f"seed={seed}"], config_dir=str(ROOT / "configs"))
        trainer = build_trainer(cfg, device="cuda")
        trainer.init_done()
        bns = {m.groups for m in trainer.backend.module.modules()
               if isinstance(m, BatchNorm2d)}
        if bns != {groups}:
            raise AssertionError(f"BatchNorm groups {bns}")
        rng = np.random.RandomState(seed + groups)
        data, eval_data = [synthetic_batch(
            rng, int(cfg.batch_size), size,
            int(cfg.model.backend.params.num_classes),
            int(cfg.max_detections)) for size in (TRAIN_SIZE, EVAL_SIZE)]
        record = {}
        record["train"], record["eval"] = train_and_eval(
            trainer, cfg, data, eval_data,
            expect(dcn_fwd=n_dcn, dcn_bwd=n_dcn), expect(dcn_fwd=n_dcn),
            steps=P10_STEPS)
        later = record["train"]["step_ms"][1:]
        print(f"bn_sync={groups} DLA-34 float32 B={cfg.batch_size}: steps "
              f"2-{P10_STEPS} {' '.join(f'{ms:.1f}' for ms in later)} ms",
              flush=True)
        out[f"bn_sync_{groups}"] = record
        del trainer
        torch.cuda.empty_cache()
    return out


def ranks_through_main(n_dcn, seed):
    """Phase 10 c (CLI) and e: ``main()`` on phase 7's set with
    ``mesh.data=1`` (one NCCL rank that ``main()`` joins itself) for an
    epoch at float32 and at bfloat16, and
    ``experiment=adversarial_entropy_minimization_dla`` as shipped
    (``gpu: [0, 1]``) for an epoch: it must warn that one device is
    visible and train on it. Returns {run name: record}."""
    sets = cli_data(seed)
    out = {}
    for precision, fwd, bwd in (("float32", "dcn_fwd", "dcn_bwd"),
                                ("bfloat16", "dcn_fused_fwd",
                                 "dcn_fused_bwd")):
        run = run_cli(f"one_rank_{precision}", [
            "experiment=baseline", "batch_size=16", "mesh={data: 1}",
            "epochs=1", f"precision={precision}"] + sets,
            expect(**{fwd: n_dcn, bwd: n_dcn}), expect(**{fwd: n_dcn}))
        if not any(m.startswith("rank 0 of 1: batch")
                   for m in run["log"]):
            raise AssertionError(f"one rank {precision}: main() did not "
                                 f"run as a rank: {run['log']}")
        calls = [(p["tag"], p["graph_calls"]) for p in run["phases"]]
        if not all(c["replays"] > 0 for tag, c in calls
                   if tag == "training"):
            raise AssertionError(f"one rank {precision}: a training phase "
                                 f"of main() replayed no graph: {calls}")
        print(f"one rank {precision} through main(): graph calls by phase "
              f"{calls}", flush=True)
        out[f"cli_one_rank_{precision}"] = run
    warning = ("requested 2-way data parallelism but only 1 device(s) "
               "available; running single-device")
    run = run_cli("advent_dla", [
        "experiment=adversarial_entropy_minimization_dla",
        "precision=float32", "epochs=1"] + sets + cli_target_domain(),
        expect(dcn_fwd=2 * n_dcn, dcn_bwd=2 * n_dcn),
        expect(dcn_fwd=2 * n_dcn))
    if warning not in run["log"]:
        raise AssertionError(f"ADVENT on DLA-34: no single-device warning "
                             f"in {run['log']}")
    print(f"ADVENT on DLA-34 as shipped (gpu: [0, 1]): warned "
          f"'{warning}' and trained on the card", flush=True)
    out["cli_advent_dla"] = run
    return out


def pooling_card_vs_cpu(seed):
    """Phase 10 f: ``DCNPooling`` (plain PyTorch; the JAX package has no
    kernel for it) at POOL's shape on the card against the same module and
    inputs on the CPU: output and the gradients of x and of the fc layers
    within POOL_TOL of their scale. Returns the record."""
    import numpy as np
    import torch

    from centernet_uda_torch.ops.dcn_pooling import DCNPooling

    p = POOL
    rng = np.random.RandomState(seed)
    channels = p["output_dim"] * p["group"] ** 2
    x = rng.randn(p["batch"], channels, p["size"], p["size"]).astype(
        np.float32)
    n = p["rois_per_image"] * p["batch"]
    corner = rng.rand(n, 2) * 380
    extent = rng.rand(n, 2) * 250 + 16
    rois = np.concatenate([np.repeat(np.arange(p["batch"]),
                                     p["rois_per_image"])[:, None],
                           corner, np.minimum(corner + extent, 511)],
                          1).astype(np.float32)
    module = DCNPooling(p["spatial_scale"], p["pooled"], p["output_dim"],
                        False, p["group"], trans_std=p["trans_std"],
                        deform_fc_dim=p["fc_dim"],
                        generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():  # offsets and a mask away from fc3's zero init
        module.fc3.weight.normal_(0.0, 0.02, generator=torch.Generator()
                                  .manual_seed(seed + 1))
        module.fc3.bias.normal_(0.0, 0.5, generator=torch.Generator()
                                .manual_seed(seed + 2))
    coef = rng.randn(n, p["output_dim"], p["pooled"], p["pooled"]).astype(
        np.float32)

    def run(device):
        mod = DCNPooling(p["spatial_scale"], p["pooled"], p["output_dim"],
                         False, p["group"], trans_std=p["trans_std"],
                         deform_fc_dim=p["fc_dim"]).to(device)
        mod.load_state_dict(module.state_dict())
        xt = torch.tensor(x, device=device, requires_grad=True)
        out = mod(xt, torch.tensor(rois, device=device))
        (out * torch.tensor(coef, device=device)).sum().backward()
        grads = {"x": xt.grad, **{k: q.grad for k, q in
                                  mod.named_parameters()}}
        return out.detach().cpu(), {k: g.cpu() for k, g in grads.items()}

    want, want_grads = run("cpu")
    got, got_grads = run("cuda")
    errs = {}
    for k, g, w in [("out", got, want)] + [
            (f"d{k}", got_grads[k], want_grads[k]) for k in want_grads]:
        scale = float(w.abs().max())
        errs[k] = float((g.double() - w.double()).abs().max())
        if not (bool(torch.isfinite(g).all())
                and errs[k] <= POOL_TOL * scale):
            raise AssertionError(f"DCNPooling {k} card vs CPU: max |err| "
                                 f"{errs[k]}, scale {scale}")
    xt = torch.tensor(x, device="cuda", requires_grad=True)
    mod = module.cuda()
    roi_t = torch.tensor(rois, device="cuda")
    coef_t = torch.tensor(coef, device="cuda")
    ms = time_ms(lambda: (mod(xt, roi_t) * coef_t).sum().backward())
    print(f"DCNPooling {n} RoIs on {tuple(x.shape)}: card vs CPU max |err| "
          + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
          + f"; forward + backward {ms:.3f} ms on the card", flush=True)
    return {"errs": errs, "ms": ms}


def host_pipeline():
    """Phase 11: ``tools/bench_pipeline_torch.py`` on ``PIPE_IMAGES`` JPEGs
    at ``PIPE_SIZE`` px, batch ``PIPE_BATCH``, the training augmentation,
    with each of ``PIPE_WORKERS`` loader threads, with the host library and
    with numpy: each stage's ms a sample on one thread and the loader's
    images a second. Returns the records."""
    sys.path.insert(0, str(ROOT / "tools"))
    from bench_pipeline_torch import bench

    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    out = {}
    for workers in PIPE_WORKERS:
        rec = bench(images=PIPE_IMAGES, size=PIPE_SIZE, batch=PIPE_BATCH,
                    workers=workers, mode="thread", aug=True,
                    seconds=PIPE_SECONDS, root=scratch)
        for label, r in (("host library", rec), ("numpy", rec["numpy"])):
            rate = r["pipeline_images_per_sec"]
            if not rate > 0 or not all(
                    v is not None and v >= 0
                    for v in r["stage_ms_per_sample"].values()):
                raise AssertionError(f"host pipeline {label}: {r}")
            stages = ", ".join(f"{k} {v:.3f}" for k, v in
                               r["stage_ms_per_sample"].items())
            print(f"host pipeline, {workers} threads, {label}: {rate:.2f} "
                  f"images/s; ms a sample: {stages}", flush=True)
        out[f"threads_{workers}"] = rec
    return out


# phase 11's early stop, run in a fresh process: leaves a process loader
# after one batch and prints each stop's seconds
LOADER_STOP_SCRIPT = r"""
import json, sys, tempfile, time
from pathlib import Path
root, workers, images, size, batch, times = sys.argv[1:7]
sys.path.insert(0, root)
sys.path.insert(0, root + "/tools")
from bench_pipeline_torch import default_augmentation, write_jpeg_coco
from centernet_uda_torch.data.coco import Dataset
from centernet_uda_torch.data.loader import DataLoader

with tempfile.TemporaryDirectory(dir=root + "/build") as tmp:
    img, anno = write_jpeg_coco(Path(tmp), int(images), int(size))
    ds = Dataset(str(img), str(anno), input_size=[int(size)] * 2,
                 augmentation=default_augmentation(), num_classes=6,
                 max_detections=150, seed=0)
    seconds = []
    for _ in range(int(times)):
        loader = DataLoader(ds, batch_size=int(batch), shuffle=True,
                            num_workers=int(workers), worker_mode="process",
                            drop_last=True, prefetch=4)
        for _ in loader:
            t0 = time.perf_counter()
            break
        seconds.append(time.perf_counter() - t0)
print(json.dumps({"stop_seconds": seconds}))
"""


def process_loader_stop():
    """Phase 11's early stop (ROADMAP C3): a process loader of
    ``STOP_WORKERS`` workers on ``STOP_IMAGES`` JPEGs at ``PIPE_SIZE`` px
    with the training augmentation, left after one batch ``STOP_TIMES``
    times in a fresh process; each stop must return within
    ``STOP_LIMIT_S``. Returns the stops' seconds."""
    import os
    import signal

    (ROOT / "build").mkdir(exist_ok=True)
    proc = subprocess.Popen(
        [sys.executable, "-c", LOADER_STOP_SCRIPT, str(ROOT),
         str(STOP_WORKERS), str(STOP_IMAGES), str(PIPE_SIZE),
         str(PIPE_BATCH), str(STOP_TIMES)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=STOP_PROCESS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        out, err = "", f"no end within {STOP_PROCESS_TIMEOUT_S} s"
    finally:
        try:  # the process and its loader's workers, should any be left
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    if proc.returncode != 0 or not out.strip():
        raise AssertionError(f"process loader stop: exit {proc.returncode}"
                             f"\n{err[-2000:]}")
    seconds = json.loads(out.strip().splitlines()[-1])["stop_seconds"]
    print(f"process loader, {STOP_WORKERS} workers, left after one batch "
          f"{STOP_TIMES} times: back in {', '.join(f'{t:.3f}' for t in seconds)}"
          f" s", flush=True)
    if len(seconds) != STOP_TIMES or max(seconds) >= STOP_LIMIT_S:
        raise AssertionError(f"process loader stops took {seconds} s")
    return seconds


def run_bench(precision, knobs, n_dcn, step_ms):
    """Phase 12, one run of ``python -m centernet_uda_torch.bench`` with
    ``knobs``: every stage's number, ``mfu_train`` in (0, 1) at bfloat16,
    the train rate within ``BENCH_RATE_TOL`` of the batch over the median
    of ``step_ms`` from the third step on (phase 4's replayed train steps at
    this precision), and exactly
    this precision's DCN launches. Returns the bench's JSON object."""
    import os

    import numpy as np

    env = {**os.environ, **knobs}
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "centernet_uda_torch.bench"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"bench {precision}: exit {out.returncode}\n"
                             f"{out.stderr[-3000:]}")
    line = out.stdout.strip().splitlines()[-1]
    print(f"bench {precision} ({seconds:.1f} s): {line}", flush=True)
    res = json.loads(line)
    d = res["detail"]
    allowed = {f"{stage}_skip_reason" for stage, knob in (
        ("infer_800px", "BENCH_800"), ("pipeline", "BENCH_PIPELINE"))
        if knobs.get(knob) == "0"}
    if precision == "float32":
        allowed.add("mfu_skip_reason")
    skipped = {k: v for k, v in d.items()
               if k.endswith("_skip_reason") and k not in allowed}
    if skipped or res["vs_baseline"] is not None:
        raise AssertionError(f"bench {precision}: skipped {skipped}")
    for key in ("decode_mean_ms_pipelined", "dcn_fwd_ms", "dcn_bwd_ms",
                "train_images_per_sec", "infer_images_per_sec",
                "train_images_per_sec_scan", "infer_images_per_sec_scan"):
        if not (isinstance(d[key], (int, float)) and d[key] > 0):
            raise AssertionError(f"bench {precision}: {key} = {d[key]}")
    if precision == "bfloat16" and not 0 < d["mfu_train"] < 1:
        raise AssertionError(f"bench mfu_train {d['mfu_train']}")
    # phase 4's steps from the third on replay its graph, as the bench's
    # timed steps do (the first runs eagerly, the second captures)
    want_ips = d["batch_size"] * 1e3 / float(np.median(step_ms[2:]))
    ratio = d["train_images_per_sec"] / want_ips
    print(f"bench {precision} train {d['train_images_per_sec']:.2f} images/s "
          f"against {want_ips:.2f} from phase 4's median replayed step "
          f"({ratio:.3f}x)", flush=True)
    if abs(ratio - 1) > BENCH_RATE_TOL:
        raise AssertionError(f"bench {precision} train rate {ratio:.3f}x "
                             "phase 4's")
    fwd, bwd = (("dcn_fused_fwd", "dcn_fused_bwd") if precision == "bfloat16"
                else ("dcn_fwd", "dcn_bwd"))
    # the warm-up is at least 2 calls on the card (eager, then capture)
    warmup = max(int(knobs.get("BENCH_WARMUP", 3)), 2)
    steps = int(knobs["BENCH_STEPS"])
    calls = warmup + steps
    want = expect(**{fwd: n_dcn * 2 * calls, bwd: n_dcn * calls})
    if d["dcn_launches"] != want:
        raise AssertionError(f"bench {precision} launches "
                             f"{d['dcn_launches']} != {want}")
    # each scan: an eager chunk, a captured one, then the timed chunks
    calls = d["scan_chunk"] * (2 + d["scan_chunks"])
    want = expect(**{fwd: n_dcn * 2 * calls, bwd: n_dcn * calls})
    if d["scan_dcn_launches"] != want:
        raise AssertionError(f"bench {precision} scan launches "
                             f"{d['scan_dcn_launches']} != {want}")
    print(f"bench {precision} scan: train "
          f"{d['train_images_per_sec_scan']:.2f}, infer "
          f"{d['infer_images_per_sec_scan']:.2f} images/s", flush=True)
    res["seconds"] = seconds
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write every measurement here")
    parser.add_argument("--profile", action="store_true",
                        help="after the checks, profile two train steps at "
                             "each precision with torch.profiler")
    parser.add_argument("--parent", help="a checkout of another commit whose "
                        "kernels are timed beside this one's")
    parser.add_argument("--seed", type=int, default=42,
                        help="seed of the CLI phase's dataset and config")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "centernet_uda_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(centernet_uda_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from centernet_uda_torch.config import compose
    from centernet_uda_torch.ops import dcn_cuda
    from centernet_uda_torch.train import build_trainer

    report = {}
    device = torch.device("cuda")
    # the twins' f32 convolutions and products in full f32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase("probe")
    smi = nvidia_smi()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    nvcc = subprocess.run([dcn_cuda.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(nvcc.stdout.strip().splitlines()[-1])
    cap = torch.cuda.get_device_capability(0)
    print(f"device {torch.cuda.get_device_name(0)} capability {cap}")
    print(f"host libraries: {library_versions()}")
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; this card is "
                           f"capability {cap}")
    report["card"] = smi

    phase("build")
    t0 = time.time()
    print(dcn_cuda.compiler_report(dcn_cuda.build_kernels()))
    from centernet_uda_torch import native

    native.load()
    print(f"host library: {native.lib_path()}")
    report["build_s"] = time.time() - t0
    print(f"built in {report['build_s']:.1f} s", flush=True)

    cfg = compose(["experiment=baseline"], config_dir=str(ROOT / "configs"))
    trainer = build_trainer(cfg, device="cuda")
    trainer.init_done()
    net = trainer.backend.module
    if (cfg.precision, cfg.dcn_impl) != ("float32", "auto"):
        raise RuntimeError("expected the baseline's float32 / auto")
    train_shapes = dcn_shapes(net, TRAIN_SIZE, device)
    eval_shapes = dcn_shapes(net, EVAL_SIZE, device)
    n_dcn = sum(train_shapes.values())
    print(f"DCN layers: {n_dcn}; train shapes {train_shapes}; eval shapes "
          f"{eval_shapes}", flush=True)
    train_label = f"train{TRAIN_SIZE}"

    # the MobileNetV2 path's DCN shapes, and the widest DLA-34 layers at
    # WIDE_SIZE (their route under "auto" is select; phase 6 forces lanes)
    from centernet_uda_torch.ops.dcn import LANES_NATIVE_MAX_W, kernel_route

    cfg_m = compose(["experiment=baseline_mobilenet_v2",
                     "model.backend.params.use_dcn=true"],
                    config_dir=str(ROOT / "configs"))
    if int(cfg_m.batch_size) != MNV2_TRAIN_BATCH:
        raise RuntimeError(f"expected batch {MNV2_TRAIN_BATCH}")
    mnv2 = build_trainer(cfg_m, device="cuda").backend.module
    m_train = dcn_shapes(mnv2, TRAIN_SIZE, device)
    m_eval = dcn_shapes(mnv2, EVAL_SIZE, device)
    del mnv2

    def routes(shapes, dtype):
        return {k: kernel_route((1, k[0], k[2], k[3]), dtype,
                                (k[1], k[0], 3, 3)) for k in shapes}

    for shapes in (m_train, m_eval):
        want_routes = {k: "select" if k[0] == 1280 else "lanes"
                       for k in shapes}
        if routes(shapes, torch.float32) != want_routes or sorted(
                want_routes.values()) != ["lanes", "lanes", "select"]:
            raise AssertionError(f"MobileNetV2 routes "
                                 f"{routes(shapes, torch.float32)}")
    sel_train = {k: n for k, n in m_train.items() if k[0] == 1280}
    m_fused = {k: n for k, n in m_train.items() if k[0] != 1280}
    sel_eval = {k: n for k, n in m_eval.items() if k[0] == 1280}
    wide_shapes = {k: n for k, n in dcn_shapes(net, WIDE_SIZE, device).items()
                   if k[3] > LANES_NATIVE_MAX_W}
    b300, c300, o300, h300, w300 = SHAPE_300
    shape_300 = {(c300, o300, h300, w300): 1}
    print(f"MobileNetV2 DCN shapes: train {m_train}, eval {m_eval}; "
          f"DLA-34 at {WIDE_SIZE} px wider than {LANES_NATIVE_MAX_W}: "
          f"{wide_shapes}", flush=True)
    train_label = f"train{TRAIN_SIZE}"
    m_label, wide_label = f"mnv2_train{TRAIN_SIZE}", f"lanes{WIDE_SIZE}"
    uda_label = f"uda_train{TRAIN_SIZE}"

    phase("kernels against their plain twin")
    parent = load_parent(args.parent) if args.parent else None
    records = check_kernels(train_shapes, TRAIN_BATCH, device, train_label,
                            parent=parent)
    records += check_kernels(eval_shapes, EVAL_BATCH_KERNELS, device,
                             f"eval{EVAL_SIZE}", parent=parent)
    records += check_kernels(train_shapes, UDA_BATCH, device, uda_label,
                             parent=parent)
    report["shapes"] = records
    phase("fused bf16 kernels against their plain twin")
    fused = check_fused_kernels(train_shapes, TRAIN_BATCH, device,
                                train_label, parent)
    fused += check_fused_kernels(eval_shapes, EVAL_BATCH_KERNELS, device,
                                 f"eval{EVAL_SIZE}", parent)
    fused += check_fused_kernels(m_fused, MNV2_TRAIN_BATCH, device, m_label,
                                 parent)
    fused += check_fused_kernels(train_shapes, UDA_BATCH, device, uda_label,
                                 parent)
    report["fused_shapes"] = fused
    for name, outs, recs in (("dcn_fwd", ("out",), records),
                             ("dcn_bwd", ("dx",), records),
                             ("dcn_fused_fwd", ("out",), fused),
                             ("dcn_fused_bwd", ("dx",), fused)):
        line = kernel_line(name, "", "", outs, recs, uda_label, 0)
        print(f"{name} at B={UDA_BATCH}, one pass over the {n_dcn} layers: "
              f"{line['ms']:.3f} ms (twin {line['plain_ms']:.3f}, library "
              f"{line['library_ms']:.3f}, bound {line['bound_ms']:.4f} "
              f"{line['bound_by']})", flush=True)
    largest = max(train_shapes, key=lambda k: k[0] * (k[1] + 27) * k[2] * k[3])
    report["fused_call_launches"] = profile_fused_call(largest, TRAIN_BATCH,
                                                       device)
    report["f32_call_launches"] = profile_explicit_pair(
        "f32", "float32", largest, TRAIN_BATCH, device)
    phase("select kernels against their plain twin")
    select = []
    for dtype in ("float32", "bfloat16"):
        select += check_kernels(sel_train, MNV2_TRAIN_BATCH, device, m_label,
                                "select", dtype, parent)
        select += check_kernels(sel_eval, EVAL_BATCH_KERNELS, device,
                                f"mnv2_eval{EVAL_SIZE}", "select", dtype,
                                parent)
        select += check_kernels(shape_300, b300, device, "w300", "select",
                                dtype, parent)
    report["select_shapes"] = select
    report["select_call_launches"] = profile_explicit_pair(
        "select", "bfloat16", max(sel_train), MNV2_TRAIN_BATCH, device)
    phase("wide forward against its plain twin")
    wide = []
    for dtype in ("float32", "bfloat16"):
        wide += check_wide_kernel(wide_shapes, WIDE_BATCH, device,
                                  wide_label, dtype, parent)
        wide += check_wide_kernel(shape_300, b300, device, "w300", dtype,
                                  parent)
    del parent
    report["wide_shapes"] = wide

    rng = np.random.RandomState(int(cfg.seed))
    num_classes = int(cfg.model.backend.params.num_classes)
    max_det = int(cfg.max_detections)
    data = synthetic_batch(rng, int(cfg.batch_size), TRAIN_SIZE, num_classes,
                           max_det)
    eval_data = synthetic_batch(rng, int(cfg.batch_size), EVAL_SIZE,
                                num_classes, max_det)

    phase("float32 train and eval")
    report["heads_vs_exact_max_abs_err"] = check_heads_against_exact(
        trainer, device)
    report["train"], report["eval"] = train_and_eval(
        trainer, cfg, data, eval_data, expect(dcn_fwd=n_dcn, dcn_bwd=n_dcn),
        expect(dcn_fwd=n_dcn))
    if args.profile:
        report["profile"] = profile_train_steps(trainer, data)
    del trainer, net
    torch.cuda.empty_cache()

    phase("bfloat16 train and eval")
    cfg16 = compose(["experiment=baseline", "precision=bfloat16"],
                    config_dir=str(ROOT / "configs"))
    trainer16 = build_trainer(cfg16, device="cuda")
    trainer16.init_done()
    report["bf16_heads_vs_exact_max_abs_err"] = check_heads_against_exact(
        trainer16, device, bf16=True)
    report["bf16_train"], report["bf16_eval"] = train_and_eval(
        trainer16, cfg16, data, eval_data,
        expect(dcn_fused_fwd=n_dcn, dcn_fused_bwd=n_dcn),
        expect(dcn_fused_fwd=n_dcn))
    if args.profile:
        report["bf16_profile"] = profile_train_steps(trainer16, data)
    del trainer16, data, eval_data
    torch.cuda.empty_cache()

    m_num_classes = int(cfg_m.model.backend.params.num_classes)
    m_data = synthetic_batch(rng, MNV2_TRAIN_BATCH, TRAIN_SIZE,
                             m_num_classes, max_det)
    m_eval_data = synthetic_batch(rng, MNV2_TRAIN_BATCH, EVAL_SIZE,
                                  m_num_classes, max_det)
    for precision, lanes_fwd, lanes_bwd in (
            ("float32", "dcn_fwd", "dcn_bwd"),
            ("bfloat16", "dcn_fused_fwd", "dcn_fused_bwd")):
        phase(f"MobileNetV2 {precision} train and eval")
        cfg_p = compose(["experiment=baseline_mobilenet_v2",
                         "model.backend.params.use_dcn=true",
                         f"precision={precision}"],
                        config_dir=str(ROOT / "configs"))
        trainer_m = build_trainer(cfg_p, device="cuda")
        trainer_m.init_done()
        key = "mnv2" if precision == "float32" else "mnv2_bf16"
        report[f"{key}_heads_vs_exact_max_abs_err"] = (
            check_heads_against_exact(trainer_m, device,
                                      bf16=precision == "bfloat16"))
        report[f"{key}_train"], report[f"{key}_eval"] = train_and_eval(
            trainer_m, cfg_p, m_data, m_eval_data,
            expect(dcn_sel_fwd=1, dcn_sel_bwd=1, **{lanes_fwd: 2,
                                                    lanes_bwd: 2}),
            expect(dcn_sel_fwd=1, **{lanes_fwd: 2}))
        if args.profile:
            report[f"{key}_profile"] = profile_train_steps(trainer_m, m_data)
        del trainer_m
        torch.cuda.empty_cache()
    del m_data, m_eval_data

    phase(f"forced lanes: DLA-34 float32 eval at {WIDE_SIZE} px")
    cfg_w = compose(["experiment=baseline", f"batch_size={WIDE_BATCH}"],
                    config_dir=str(ROOT / "configs"))
    report["lanes_eval"] = forced_lanes_eval(cfg_w, device)
    torch.cuda.empty_cache()

    phase("CLI on data: DLA-34 trains, evaluates and resumes through main()")
    report.update(cli_on_data(n_dcn, args.seed, args.profile))

    uda = uda_trainers(n_dcn, args.seed, args.profile)
    report.update(uda)

    p9 = backbones_rotated_keypoints(n_dcn, args.seed)
    report.update(p9)

    phase("serving export: DLA-34 and MobileNetV2 artifacts on the card")
    served = serve_artifacts(n_dcn, args.seed)
    report["served"] = served
    phase("one NCCL rank: DLA-34 steps against the plain step")
    one_rank = one_rank_steps(n_dcn, args.seed)
    report["one_rank"] = one_rank
    p10 = grouped_bn_steps(n_dcn, args.seed)
    phase("ranks through main(): mesh.data=1, ADVENT on DLA-34 as shipped")
    p10.update(ranks_through_main(n_dcn, args.seed))
    report.update(p10)
    phase("DCNPooling on the card against the CPU")
    report["dcn_pooling"] = pooling_card_vs_cpu(args.seed)
    phase(f"host pipeline: the loader bench at {PIPE_SIZE} px, batch "
          f"{PIPE_BATCH}, {PIPE_WORKERS} threads")
    report["host_pipeline"] = host_pipeline()
    report["loader_stop_seconds"] = process_loader_stop()

    phase("bench: python -m centernet_uda_torch.bench, bfloat16 and float32")
    report["bench"] = {
        precision: run_bench(precision, knobs, n_dcn, report[
            "bf16_train" if precision == "bfloat16" else "train"]["step_ms"])
        for precision, knobs in BENCH_RUNS.items()}

    phase(f"compiled steps: graphed against eager at {TRAIN_SIZE} px")
    report["compiled"] = compiled_steps(n_dcn, args.seed)

    runs = [report[k]["launches"] for k in (
        "train", "eval", "bf16_train", "bf16_eval", "mnv2_train",
        "mnv2_eval", "mnv2_bf16_train", "mnv2_bf16_eval", "lanes_eval",
        "cli_f32", "cli_resume", "cli_bf16", "cli_f32_numpy", "cli_prefixed",
        "cli_mnv2", "cli_resnet18", "cli_advent", "cli_advent_resume",
        "cli_coco_merged")]
    runs += [r[part]["launches"] for r in (*uda.values(), *p9.values())
             for part in ("train", "eval")]
    runs += [r["launches"] for r in served.values()]
    runs += [run["launches"] for r in one_rank.values()
             for run in r["runs"].values()]
    runs += [r["launches"] for k, r in p10.items() if k.startswith("cli_")]
    runs += [r[part]["launches"] for k, r in p10.items()
             if k.startswith("bn_sync_") for part in ("train", "eval")]
    runs += [r["detail"][k] for r in report["bench"].values()
             for k in ("dcn_launches", "scan_dcn_launches")]
    runs += [r[part]["launches"] for r in report["compiled"].values()
             for part in ("eager", "graphed")]

    def launches(name):
        return sum(run[name] for run in runs)

    csrc = "centernet_uda_torch/csrc"
    pallas = "centernet_uda_tpu/ops/dcn_pallas.py"
    f32_outs = ("dx", "doff", "dmask", "dw", "dbias")
    f16_outs = ("dx", "dom_w", "dom_b", "dw", "dbias")
    kernels = [
        kernel_line("dcn_fwd", f"{csrc}/dcn_fwd.cu", f"{pallas}:210",
                    ("out",), records, train_label, launches("dcn_fwd")),
        kernel_line("dcn_wide_fwd", f"{csrc}/dcn_wide_fwd.cu",
                    f"{pallas}:531", ("out",), wide, wide_label,
                    launches("dcn_wide_fwd"), "float32"),
        kernel_line("dcn_bwd", f"{csrc}/dcn_bwd.cu", f"{pallas}:571",
                    f32_outs, records, train_label, launches("dcn_bwd")),
        kernel_line("dcn_fused_fwd", f"{csrc}/dcn_fused_fwd.cu",
                    f"{pallas}:982", ("out",), fused, train_label,
                    launches("dcn_fused_fwd")),
        kernel_line("dcn_fused_bwd", f"{csrc}/dcn_fused_bwd.cu",
                    f"{pallas}:1153", f16_outs, fused, train_label,
                    launches("dcn_fused_bwd")),
        kernel_line("dcn_sel_fwd", f"{csrc}/dcn_sel_fwd.cu",
                    f"{pallas}:1544", ("out",), select, m_label,
                    launches("dcn_sel_fwd"), "float32"),
        kernel_line("dcn_sel_bwd", f"{csrc}/dcn_sel_bwd.cu",
                    f"{pallas}:1675", f32_outs, select, m_label,
                    launches("dcn_sel_bwd"), "float32"),
    ]
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    if missing or len(kernels) != len(dcn_cuda.SOURCES):
        raise AssertionError(f"kernels not launched on a main path: "
                             f"{missing}")
    report["kernels"] = kernels
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
