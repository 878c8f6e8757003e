"""Smoke run of the PyTorch/CUDA port (``centernet_uda_torch``) on one card.

    python3 chip_smoke.py [--json PATH] [--profile] [--parent DIR]

Run from the root of a checkout on a machine with an NVIDIA H100. Phases:

1. probe: the card, its power limit, torch, CUDA, nvcc; the card must be
   compute capability 9.0;
2. build: compiles the seven DCN kernel sources from
   ``centernet_uda_torch/csrc/`` (one ``nvcc`` each, in parallel) and prints
   the compiler's register / shared-memory report;
3. kernels: each kernel against its plain PyTorch twin on the same inputs
   (atol 5e-2 * max(1, max|twin|), rtol 5e-2: the bound of the Pallas
   kernels' own tests; max |dy| to 1e-5 relative), timed beside its twin
   and a cuDNN yardstick:
   - the float32 pair and the fused bfloat16 pair at every DCN shape of
     DLA-34's 512 px train path (batch 16) and 800 px eval path (batch 4),
     and the fused pair at MobileNetV2's 256 -> 256 shapes (@32 and @64,
     batch 32); one call of the fused pair at the largest DLA-34 shape is
     profiled for its launches (1 forward, 4 backward) and each launch's
     device time, and so is one call of the float32 backward there (2
     launches);
   - the "select" pair, in float32 and in bfloat16, at MobileNetV2's
     1280 -> 256 DCN shapes (512 px train, batch 32: 16 x 16; 800 px eval,
     batch 4: 25 x 25) and at 2 x 300 x 300 x 64; one bfloat16 call of its
     backward at the train shape is profiled (2 launches);
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
   ``dcn_wide_fwd`` and the rest ``dcn_fwd``.

Before each model trains, its heads on the kernel path are held against the
exact DCN op on the same weights and a small input. Every phase drives the
entry points a user calls (``build_trainer``, ``Model.step``,
``get_detections``) with the launch counters set to 0 just before and read
just after. The last lines are a ``{"kernels": [...]}`` JSON line (one
entry per kernel source, launches summed over phases 4-6), the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": {...}}``.
Any failure exits non-zero. ``--json PATH`` also writes every measurement
to PATH; ``--profile`` adds a torch.profiler breakdown by kernel of two
more train steps of each model at each precision; ``--parent DIR`` (a
checkout of another commit, e.g. ``git archive`` of the parent unpacked
under ``build/``) builds that checkout's kernels too and times, in the same
run and in turns (its, this, this, its), its fused pair at every fused
shape and its float32 and select backwards at every shape of theirs.
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
    another checkout's ``dcn_cuda`` module, has its backward timed beside
    this one's, in turns."""
    import torch
    import torch.nn.functional as F

    from centernet_uda_torch.ops import dcn_cuda

    fwd, bwd = (getattr(dcn_cuda, n) for n in EXPLICIT_PAIRS[pair])
    parent_bwd = parent and getattr(parent, EXPLICIT_PAIRS[pair][1])
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
        bwd_ms, parent_bwd_ms = time_in_turns(
            lambda: bwd(x, off, m, wt, g),
            parent_bwd and (lambda: parent_bwd(x, off, m, wt, g)))
        t = {
            "fwd_ms": time_ms(lambda: fwd(x, off, m, wt, bias)),
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
        if parent_bwd_ms is not None:
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


def check_wide_kernel(shapes, batch, device, label, dtype="float32"):
    """Phase 3 for the wide forward (both offsets clamped) in ``dtype``:
    against ``dcn_v2_twin(..., clamp_dx=True)``, with dx scaled to std 16
    so many samples pass the clamp. Its backward is the exact op's, not a
    kernel. Returns per-shape records."""
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
        t = {
            "fwd_ms": time_ms(lambda: dcn_cuda.dcn_wide_forward(
                x, off, m, wt, bias)),
            "twin_fwd_ms": time_ms(lambda: dcn_cuda.dcn_v2_twin(
                x, off, m, wt, bias, clamp_dx=True)),
            "conv_fwd_ms": time_ms(lambda: F.conv2d(
                x, wt.to(dt), bias.to(dt), padding=1)),
        }
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
              f"conv {t['conv_fwd_ms']:.3f}, bound {fb:.4f} {fk})",
              flush=True)
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


def profile_explicit_backward(pair, dtype, shape, batch, device):
    """One call of the explicit-offset backward of ``pair`` ("f32" or
    "select") in ``dtype`` at ``shape`` under torch.profiler: it must
    launch 2 kernels."""
    import torch

    from centernet_uda_torch.ops import dcn_cuda

    cin, cout, h, w = shape
    x, off, m, wt, _, g = make_operands(8, batch, cin, cout, h, w, device)
    dt = getattr(torch, dtype)
    x, wt, g = x.to(dt), wt.to(dt), g.to(dt)
    bwd = getattr(dcn_cuda, EXPLICIT_PAIRS[pair][1])
    launches = profile_launches(
        f"{pair} {dtype} bwd B={batch} {cin}->{cout} @{h}x{w}",
        lambda: bwd(x, off, m, wt, g), 2)
    del x, off, m, wt, g
    torch.cuda.empty_cache()
    return launches


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


def synthetic_batch(rng, batch, size, num_classes, max_det, down_ratio=4):
    """A seeded detection batch, targets encoded as the data pipeline
    does."""
    import numpy as np

    from centernet_uda_torch.ops.gaussian import encode_targets

    out = size // down_ratio
    per_image = []
    for _ in range(batch):
        n = rng.randint(5, 30)
        xy = rng.rand(n, 2) * out * 0.85
        wh = rng.rand(n, 2) * out * 0.25 + 2.0
        boxes = np.concatenate([xy, np.minimum(xy + wh, out - 1)], 1)
        per_image.append(encode_targets(boxes, rng.randint(0, num_classes, n),
                                        out, out, num_classes, max_det))
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


def train_and_eval(trainer, cfg, data, eval_data, per_step, per_eval):
    """Phases 4 and 5 for one trainer: TRAIN_STEPS train steps, then one
    eval step with decode. ``per_step``/``per_eval`` are the launches each
    kernel must make in one train step / the eval step; every other kernel
    must not launch."""
    import numpy as np
    import torch

    from centernet_uda_torch.ops import dcn_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    dcn_cuda.reset_launches()
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        stats = trainer.step(data, is_training=True)["stats"]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(v) for k, v in stats.items()}
        if trainer.maybe_degrade_dcn(vals["dcn_max_abs_dy"]):
            raise AssertionError("the DCN offsets reached the clamp")
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"non-finite train stats {vals}")
        losses.append(vals)
        print(f"step {i}: {step_ms[-1]:.1f} ms " + " ".join(
            f"{k}={v:.5f}" for k, v in vals.items()), flush=True)
    train_launches = dict(dcn_cuda.LAUNCHES)
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
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
    if boxes.shape != (int(cfg.batch_size), max_det, 4):
        raise AssertionError(f"pred_boxes shape {boxes.shape}")
    if not (np.isfinite(boxes).all() and np.isfinite(dets["pred_scores"]).all()
            and all(math.isfinite(v) for v in vals.values())):
        raise AssertionError("non-finite eval outputs")
    if trainer.maybe_degrade_dcn(vals["dcn_max_abs_dy"]):
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write every measurement here")
    parser.add_argument("--profile", action="store_true",
                        help="after the checks, profile two train steps at "
                             "each precision with torch.profiler")
    parser.add_argument("--parent", help="a checkout of another commit whose "
                        "fused pair is timed beside this one's")
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

    phase("kernels against their plain twin")
    parent = load_parent(args.parent) if args.parent else None
    records = check_kernels(train_shapes, TRAIN_BATCH, device, train_label,
                            parent=parent)
    records += check_kernels(eval_shapes, EVAL_BATCH_KERNELS, device,
                             f"eval{EVAL_SIZE}", parent=parent)
    report["shapes"] = records
    phase("fused bf16 kernels against their plain twin")
    fused = check_fused_kernels(train_shapes, TRAIN_BATCH, device,
                                train_label, parent)
    fused += check_fused_kernels(eval_shapes, EVAL_BATCH_KERNELS, device,
                                 f"eval{EVAL_SIZE}", parent)
    fused += check_fused_kernels(m_fused, MNV2_TRAIN_BATCH, device, m_label,
                                 parent)
    report["fused_shapes"] = fused
    largest = max(train_shapes, key=lambda k: k[0] * (k[1] + 27) * k[2] * k[3])
    report["fused_call_launches"] = profile_fused_call(largest, TRAIN_BATCH,
                                                       device)
    report["f32_bwd_call_launches"] = profile_explicit_backward(
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
    del parent
    report["select_shapes"] = select
    report["select_bwd_call_launches"] = profile_explicit_backward(
        "select", "bfloat16", max(sel_train), MNV2_TRAIN_BATCH, device)
    phase("wide forward against its plain twin")
    wide = []
    for dtype in ("float32", "bfloat16"):
        wide += check_wide_kernel(wide_shapes, WIDE_BATCH, device,
                                  wide_label, dtype)
        wide += check_wide_kernel(shape_300, b300, device, "w300", dtype)
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

    runs = [report[k]["launches"] for k in (
        "train", "eval", "bf16_train", "bf16_eval", "mnv2_train",
        "mnv2_eval", "mnv2_bf16_train", "mnv2_bf16_eval", "lanes_eval")]

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
