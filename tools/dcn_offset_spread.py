"""How the DCN backwards' time grows with the spread of the offsets, beside
another checkout's (the parent's) kernels, and how far two calls of the
wide route's backward part.

    python3 tools/dcn_offset_spread.py [--parent PATH] [--json PATH]

Run from the root of a checkout on a machine with an NVIDIA H100. The dx
kernel of the backwards (``dcn_sample_dx_kernel``,
``centernet_uda_torch/csrc/dcn_sample_bwd.cuh``) adds, for each
destination tile, the samples that the bucket kernel filed under it; a
design whose work grows with how far the offsets reach, or a scatter with
atomics, shows here what the spread costs it. For rows 3 (f32, 64 -> 64 @128,
batch 16), 5 (fused bf16, the same shape) and 7 (select bf16, 1280 -> 256
@16, batch 32) it times the backward wrapper (CUDA events, the parent in
turns: parent, this, this, parent) and this checkout's dx kernel alone
(torch.profiler), at offsets of std 2 (``chip_smoke.py``'s operands), 4,
8 and 16 px, and at std 4 with a long tail: one (pixel, tap) in 1000 gets a
horizontal offset drawn uniformly from +-W/2. Rows 3 and 7 take the
offsets as drawn; row 5 makes them with its offset conv, whose offset
channels are scaled to the spread (the std printed is the one the conv
gave), the tail from sparse spikes of one input channel. Each result is
checked bit for bit over two calls.

The wide route (forced "lanes" at W > 256) has no backward kernel: its
gradients are autograd through the exact op, whose gathers' gradients add
with atomics on the card. The last line gives the largest difference of two
such calls over the gradient's largest magnitude, per gradient, at
DLA-34's forced-lanes shape at 1088 px (64 -> 64 @272, batch 4, f32).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SPREADS = [("std2", 2.0, False), ("std4", 4.0, False), ("std8", 8.0, False),
           ("std16", 16.0, False), ("std4+tail", 4.0, True)]
TAIL = 1e-3  # share of (pixel, tap) pairs with a far horizontal offset


def explicit_operands(seed, batch, shape, std, tail, dtype):
    """``chip_smoke.make_operands`` with offsets of ``std`` (the clamp rows
    kept) and, with ``tail``, the far horizontal offsets."""
    import numpy as np
    import torch

    import chip_smoke

    cin, cout, h, w = shape
    x, off, m, wt, bias, g = chip_smoke.make_operands(
        seed, batch, cin, cout, h, w, torch.device("cuda"))
    rng = np.random.RandomState(seed + 100)
    o = (rng.randn(batch, 18, h, w) * std).astype(np.float32)
    o[:, 0, 0, :] = 20.0
    o[:, 8, h - 1, :] = -16.0
    if tail:
        far = rng.rand(batch, 9, h, w) < TAIL
        o[:, 1::2][far] = rng.uniform(-w / 2, w / 2, int(far.sum()))
    off = torch.from_numpy(o).cuda()
    return x.to(dtype), off, m, wt.to(dtype), g.to(dtype)


def fused_operands(seed, batch, shape, std, tail):
    """``chip_smoke.make_fused_operands`` with the offset conv's offset
    channels scaled from its std of about 2 to ``std``; with ``tail``, input
    channel 1 is zero but for one pixel in 1000, where it lifts one tap's
    horizontal offset by up to +-W/2. Returns the operands and the std of
    the offsets the conv gives."""
    import torch
    import torch.nn.functional as F

    import chip_smoke

    cin, cout, h, w = shape
    x, om_w, om_b, wt, bias, g = chip_smoke.make_fused_operands(
        seed, batch, cin, cout, h, w, torch.device("cuda"))
    om_w[:18] *= std / 2
    om_b[:18] *= std / 2
    if tail:
        gen = torch.Generator("cuda").manual_seed(seed)
        spikes = torch.rand(batch, h, w, device="cuda", generator=gen) < TAIL
        x[:, 1] = spikes.to(x.dtype)
        om_w[:, 1] = 0.0
        om_w[1:18:2, 1, 1, 1] = torch.round(
            (torch.rand(9, device="cuda", generator=gen) - 0.5) * w)
    om = F.conv2d(x.float(), om_w, om_b, padding=1)
    return (x, om_w, om_b, wt, g), float(om[:, :18].std())


def dx_kernel_ms(fn, reps=3):
    """Device ms of ``dcn_sample_dx_kernel`` in one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile without device events is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms = sum(ev.device_time_total for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and "dcn_sample_dx_kernel" in ev.name) / 1e3 / reps
        if ms:
            return ms
    return None


def wide_spread():
    """{gradient: max |a - b| / max |a|} of two calls of the wide route's
    backward."""
    import torch

    import chip_smoke
    from centernet_uda_torch.ops import dcn_cuda

    x, off, m, wt, bias, g = chip_smoke.make_operands(
        3, 4, 64, 64, 272, 272, torch.device("cuda"))
    a = dcn_cuda.dcn_wide_backward(x, off, m, wt, bias, g)
    b = dcn_cuda.dcn_wide_backward(x, off, m, wt, bias, g)
    names = ("dx", "doffset", "dmask", "dw", "dbias")
    return {n: float((p - q).abs().max() / p.abs().max().clamp_min(1e-30))
            for n, p, q in zip(names, a, b)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="another checkout to time beside")
    parser.add_argument("--json", help="also write the results here")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("dcn_offset_spread: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from centernet_uda_torch.ops import dcn_cuda

    print(chip_smoke.nvidia_smi(), flush=True)
    dcn_cuda.build_kernels()
    parent = chip_smoke.load_parent(args.parent) if args.parent else None
    rows = [("row 3 f32", "dcn_backward", (64, 64, 128, 128), 16,
             torch.float32),
            ("row 5 fused bf16", "dcn_fused_backward", (64, 64, 128, 128),
             16, torch.bfloat16),
            ("row 7 select bf16", "dcn_sel_backward", (1280, 256, 16, 16),
             32, torch.bfloat16)]
    results = []
    for label, name, shape, batch, dtype in rows:
        for spread, std, tail in SPREADS:
            if name == "dcn_fused_backward":
                ops, got_std = fused_operands(7, batch, shape, std, tail)
            else:
                ops = explicit_operands(7, batch, shape, std, tail, dtype)
                got_std = float(ops[1].std())
            fn = getattr(dcn_cuda, name)
            chip_smoke.same_bits(f"{label} {spread}", fn(*ops), fn(*ops))
            parent_fn = parent and getattr(parent, name)
            ms, parent_ms = chip_smoke.time_in_turns(
                lambda: fn(*ops), parent_fn and (lambda: parent_fn(*ops)))
            dx_ms = dx_kernel_ms(lambda: fn(*ops))
            rec = {"row": label, "shape": shape, "batch": batch,
                   "spread": spread, "offset_std": got_std, "ms": ms,
                   "parent_ms": parent_ms, "dx_kernel_ms": dx_ms}
            results.append(rec)
            print(f"{label} B={batch} {shape} {spread} (std {got_std:.2f}):"
                  f" {ms:.3f} ms" + (f", parent {parent_ms:.3f}"
                                     if parent_ms is not None else "")
                  + f", dx kernel {dx_ms:.3f}", flush=True)
            del ops
    spread = wide_spread()
    print("wide route backward, two calls, max |difference| / max "
          "|gradient|: " + ", ".join(f"{k} {v:.3g}"
                                     for k, v in spread.items()), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"rows": results, "wide_backward_spread": spread}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
