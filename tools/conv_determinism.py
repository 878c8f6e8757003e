"""What keeping cuDNN to its deterministic algorithms costs DLA-34's float32
convolutions, one shape at a time.

    python3 tools/conv_determinism.py [--size 512] [--batch 16]

Run from the root of a checkout on a machine with an NVIDIA card. It
builds ``experiment=baseline`` (float32, full width), records every
``nn.Conv2d`` shape of a forward at ``--size`` px and ``--batch``, and for
each shape times the forward, the data gradient and the weight gradient
(``aten.convolution_backward``), each under cuDNN's default algorithm
choice (``_det``: under ``deterministic=True``; ``benchmark`` off, TF32
off), and the gradients by two other routes: ``_native`` with cuDNN off
(ATen's im2col and GEMM, whose sums have a fixed order) and, for a
stride-2 conv's data gradient, ``_s1x4`` (four stride-1 forward convs of
the output's gradient with the kernel's parity classes, interleaved). It
says whether three calls gave the same bits (``NONDET`` where they did
not). The last line sums each column over the shapes, weighted by how many
layers have each shape; a data gradient counts only where training runs
it (not the first conv's: the image needs no gradient). ``build_trainer``
keeps cuDNN deterministic, so the default columns are what it gives up.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def timed(fn, n=5):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def conv_shapes(size, batch):
    """{(x shape, weight shape, stride, padding, dilation, groups, whether
    training runs its data gradient): layers} of DLA-34's convolutions at
    ``size`` px."""
    import torch
    import torch.nn as nn

    from centernet_uda_torch.config import compose
    from centernet_uda_torch.train import build_trainer

    net = build_trainer(compose(["experiment=baseline"],
                                config_dir=str(ROOT / "configs")),
                        device="cuda", graphs=False).backend.module
    shapes = {}

    def hook(mod, args):
        key = (tuple(args[0].shape), tuple(mod.weight.shape),
               mod.stride[0], mod.padding[0], mod.dilation[0], mod.groups,
               args[0].requires_grad)
        shapes[key] = shapes.get(key, 0) + 1

    handles = [m.register_forward_pre_hook(hook) for m in net.modules()
               if isinstance(m, nn.Conv2d)]
    net(torch.randn(batch, 3, size, size, device="cuda"))
    for h in handles:
        h.remove()
    return shapes


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--batch", type=int, default=16)
    args = parser.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("conv_determinism: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from centernet_uda_torch.ops.conv import dgrad_s2_as_s1, routes

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    totals = {}
    for (xs, ws, st, pad, dil, gr, needs_dx), n in sorted(
            conv_shapes(args.size, args.batch).items(), key=str):
        gen = torch.Generator("cuda").manual_seed(0)
        x = torch.randn(xs, device="cuda", generator=gen)
        w = torch.randn(ws, device="cuda", generator=gen) * 0.05
        g = torch.randn(F.conv2d(x, w, None, st, pad, dil, gr).shape,
                        device="cuda", generator=gen)

        def aten(mask, cudnn=True, det=False):
            with torch.backends.cudnn.flags(
                    enabled=cudnn, benchmark=False, deterministic=det,
                    allow_tf32=False):
                if mask is None:
                    return F.conv2d(x, w, None, st, pad, dil, gr)
                out = torch.ops.aten.convolution_backward(
                    g, x, w, None, [st, st], [pad, pad], [dil, dil], False,
                    [0, 0], gr, mask)
                return out[0] if mask[0] else out[1]

        dmask, wmask = [True, False, False], [False, True, False]
        fns = {"fwd": lambda: aten(None),
               "fwd_det": lambda: aten(None, det=True),
               "dgrad": lambda: aten(dmask),
               "dgrad_det": lambda: aten(dmask, det=True),
               "dgrad_native": lambda: aten(dmask, cudnn=False),
               "wgrad": lambda: aten(wmask),
               "wgrad_det": lambda: aten(wmask, det=True),
               "wgrad_native": lambda: aten(wmask, cudnn=False)}
        if st == 2 and dil == 1 and gr == 1:
            fns["dgrad_s1x4"] = lambda: dgrad_s2_as_s1(g, w, xs, pad)
        s1x4, native_w = routes(xs, ws, st, pad, dil, gr)
        port = {"dgrad_port": "dgrad_s1x4" if s1x4 else "dgrad_det",
                "wgrad_port": "wgrad_native" if native_w else "wgrad_det"}
        times = {}
        row = []
        for name, fn in fns.items():
            outs = [fn() for _ in range(3)]
            same = all(torch.equal(outs[0], o) for o in outs[1:])
            ms = times[name] = timed(fn)
            err = ""
            if name.endswith(("_native", "_s1x4")):
                ref = fns[name.split("_")[0] + "_det"]()
                err = (f" (err {float((outs[0] - ref).abs().max()):.2g} of"
                       f" {float(ref.abs().max()):.2g})")
            if needs_dx or not name.startswith("dgrad"):
                totals[name] = totals.get(name, 0.0) + n * ms
            row.append(f"{name} {ms:.3f}" + ("" if same else " NONDET")
                       + err)
        for name, took in port.items():
            if needs_dx or name != "dgrad_port":
                totals[name] = totals.get(name, 0.0) + n * times[took]
        print(f"x{n} x{xs} w{ws} stride {st} groups {gr}"
              + ("" if needs_dx else " (no data gradient in training)")
              + ": " + ", ".join(row) + "; port: "
              + ", ".join(port.values()), flush=True)
    print("ms summed over the layers: " + ", ".join(
        f"{k} {v:.2f}" for k, v in totals.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
