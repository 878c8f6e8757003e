"""Smoke run of the PyTorch/CUDA port (``centernet_uda_torch``) on one card.

    python3 chip_smoke.py [--json PATH] [--profile] [--parent DIR] [--seed N]

Run from the root of a checkout on a machine with an NVIDIA H100. Phases:

1. probe: the card, its power limit, torch, CUDA, nvcc, the image and
   logging libraries of the host; the card must be compute capability 9.0;
2. build: compiles the seven DCN kernel sources from
   ``centernet_uda_torch/csrc/`` (one ``nvcc`` each, in parallel) and prints
   the compiler's register / shared-memory report;
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
   only), then 1 epoch at bfloat16; then
   ``experiment=adversarial_entropy_minimization`` (batch 8, the validation
   images as the target domain of both phases) for 1 epoch at float32,
   which writes ``discriminator.ckpt`` beside ``model_last.ckpt``, and a
   resume to epoch 2 that restores both optimizers; then
   ``experiment=coco_merged`` (EfficientNet-b3 with skips, rotated boxes
   and 5 keypoints, ``coco_merger`` over two source folders of 16 images
   each, with rotated boxes and keypoints in their annotations and the
   experiment's augmentation, batch 8 at 512 px, validation at 800 px with
   the rotated evaluator) for 1 epoch at float32. Each train step must
   launch the 16 layers' forward and backward kernels of its precision
   (twice for ADVENT: source and target; none for EfficientNet), each eval
   step the forwards; losses and the COCO means finite; the checkpoints
   written.
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
      parallelism is cut);
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
   DLA-34's against the exact DCN op as in phase 4.

Before each model trains, its heads on the kernel path are held against the
exact DCN op on the same weights and a small input. Every phase drives the
entry points a user calls (``build_trainer``, ``Model.step``,
``get_detections``) with the launch counters set to 0 just before and read
just after. The last lines are a ``{"kernels": [...]}`` JSON line (one
entry per kernel source, launches summed over phases 4-9), the card's
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


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


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
    DCN kernels' share and the device's busy share of the wall time."""
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
            "dcn_kernels_ms": dcn_ms,
            "top_kernels_ms_per_step": {k: v / steps for k, v in rows}}


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


def run_cli(name, overrides, per_train, per_eval, profile_steps=0):
    """Phase 7, one ``main()`` of the port's CLI on the card, run from
    ``CLI_DIR / name``. Each training step must launch ``per_train``, each
    eval step ``per_eval`` (counted from the CLI's phase records), every
    phase's loss and every ``MSCOCO_Precision``/``MSCOCO_Recall`` mean be
    finite. Returns the run's record."""
    import logging
    import os

    import torch

    from centernet_uda_torch import train
    from centernet_uda_torch.ops import dcn_cuda

    workdir = CLI_DIR / name
    workdir.mkdir(parents=True, exist_ok=True)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    ckpt_log = logging.getLogger("centernet_uda_torch.utils.checkpoint")
    ckpt_log.setLevel(logging.INFO)
    ckpt_log.addHandler(handler)
    cwd = os.getcwd()
    os.chdir(workdir)
    phases = []
    torch.cuda.synchronize()
    dcn_cuda.reset_launches()
    t0 = time.perf_counter()
    try:
        scalars = train.main(overrides + [f"profile_steps={profile_steps}"],
                             phases=phases)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        ckpt_log.removeHandler(handler)
    wall_s = time.perf_counter() - t0
    launches = dict(dcn_cuda.LAUNCHES)
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
                  f"in {p['seconds']:.2f} s + evaluator "
                  f"{p['evaluate_s']:.2f} s (loader wait "
                  f"{p['loader_wait_s'] / p['seconds']:.1%}), loss "
                  f"{p['total_loss']:.4f}", flush=True)
    print(f"CLI {name}: main() {wall_s:.1f} s, launches {launches}, mAP "
          f"{means['MSCOCO_Precision/mAP']:.5f}, mAR@100 "
          f"{means['MSCOCO_Recall/mAR100']:.5f}", flush=True)
    run = {"wall_s": wall_s, "phases": phases, "launches": launches,
           "coco": coco, "log": [r.getMessage() for r in records]}
    if profile_steps:
        run["memcpy_ms_per_step"] = memcpy_ms(
            workdir / "outputs" / "baseline" / "profile" / "trace.json",
            profile_steps)
        print(f"CLI {name}: copies per train step (device ms) "
              f"{run['memcpy_ms_per_step']}", flush=True)
    return run


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
    train_dir, train_anno = write_coco_set(CLI_DIR / "data" / "train",
                                           CLI_TRAIN_IMAGES, rng, 6)
    val_dir, val_anno = write_coco_set(CLI_DIR / "data" / "val",
                                       CLI_VAL_IMAGES, rng, 6)
    print(f"wrote {CLI_TRAIN_IMAGES} + {CLI_VAL_IMAGES} PPM images of "
          f"{CLI_IMAGE_WH} in {time.perf_counter() - t0:.1f} s", flush=True)
    sets = [f"seed={seed}", "num_workers=4",
            f"datasets.training.params.image_folder={train_dir}",
            f"datasets.training.params.annotation_file={train_anno}",
            f"datasets.validation.params.image_folder={val_dir}",
            f"datasets.validation.params.annotation_file={val_anno}"]
    common = ["experiment=baseline", "batch_size=16"] + sets
    f32 = (expect(dcn_fwd=n_dcn, dcn_bwd=n_dcn), expect(dcn_fwd=n_dcn))
    out = {"cli_f32": run_cli("f32", common + ["epochs=2",
                                               "precision=float32"],
                              *f32, profile_steps=2 if profile else 0)}
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

    # ADVENT at its own batch (8), the validation images as the target
    # domain of both phases: an epoch, then a resume of both optimizers
    target = [f"datasets.{p}.params.target_domain_glob={val_dir}/*.ppm"
              for p in ("training", "validation")]
    advent = ["experiment=adversarial_entropy_minimization",
              "precision=float32"] + sets + target
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
    run = run_cli("coco_merged", overrides, expect(), expect())
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
        record["train"], record["eval"] = train_and_eval(
            trainer, cfg, data, eval_data, per_step, per_eval,
            steps=P9_STEPS)
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

    runs = [report[k]["launches"] for k in (
        "train", "eval", "bf16_train", "bf16_eval", "mnv2_train",
        "mnv2_eval", "mnv2_bf16_train", "mnv2_bf16_eval", "lanes_eval",
        "cli_f32", "cli_resume", "cli_bf16", "cli_advent",
        "cli_advent_resume", "cli_coco_merged")]
    runs += [r[part]["launches"] for r in (*uda.values(), *p9.values())
             for part in ("train", "eval")]

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
