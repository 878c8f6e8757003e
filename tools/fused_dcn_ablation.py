"""Per-launch device time of the port's fused bf16 DCN pair, and of copies of
its sources with one part removed (an ablation, not a working kernel).

    python3 tools/fused_dcn_ablation.py [--json PATH]

Run from the root of a checkout on a machine with an NVIDIA H100. For each
shape it profiles one call of ``dcn_fused_forward`` and one of
``dcn_fused_backward`` (``centernet_uda_torch/ops/dcn_cuda.py``) with
torch.profiler and prints each launch's device ms, at two offset spreads:
the operands of ``chip_smoke.py`` (offsets of std about 2 px) and the same
with the offset conv scaled by 0.02 (offsets under a pixel, as in the first
training steps). Variants, each a copy of ``centernet_uda_torch/csrc``
built under ``build/ablation/``:

- ``tree``: the sources as they are;
- ``no_gcol_store``: the backward's data kernel (``dcn_sample_bwd.cuh``,
  shared with the explicit-offset backwards) without its store of gcol,
  which the dx kernel reads (dx comes out wrong; the time says what the
  store costs the data kernel);
- ``dx_no_hits``: the dx kernel without adding its hits (it still finds
  them; dx comes out zero; the time says what the adds cost, gcol's loads
  included).

The kernels' results are held against their twins by ``chip_smoke.py``, not
here.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = [  # ((cin, cout, h, w), batch): DLA-34 and MobileNetV2 path shapes
    ((64, 64, 128, 128), 16), ((128, 64, 64, 64), 16),
    ((512, 256, 16, 16), 16), ((256, 256, 64, 64), 32)]
VARIANTS = {
    "tree": [],
    "no_gcol_store": [(
        "dcn_sample_bwd.cuh",
        r"\*\(uint4\*\)\(gcolb \+ .*?\) = gq;",
        "(void)gcolb;")],
    "dx_no_hits": [(
        "dcn_sample_bwd.cuh", r"while \(hits\) \{", "while (false) {")],
}


def load_variant(name, edits, only=None):
    """A module instance of ops/dcn_cuda.py whose kernel sources are a copy
    of csrc/ with ``edits`` (file, pattern, replacement) applied; ``only``
    names the kernels to build (default: all)."""
    src = ROOT / "centernet_uda_torch" / "csrc"
    dst = ROOT / "build" / "ablation" / f"csrc_{name}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    for fname, pattern, repl in edits:
        path = dst / fname
        text, n = re.subn(pattern, repl, path.read_text(), flags=re.S)
        if n == 0:
            raise RuntimeError(f"{name}: no match in {fname}")
        path.write_text(text)
    spec = importlib.util.spec_from_file_location(
        f"dcn_cuda_{name}",
        ROOT / "centernet_uda_torch" / "ops" / "dcn_cuda.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.CSRC = dst
    module.BUILD_DIR = ROOT / "build" / "ablation" / f"kernels_{name}"
    if only is not None:
        module.SOURCES = {k: module.SOURCES[k] for k in only}
    module.build_kernels()
    return module


def per_launch(module, shape, batch, small_offsets, reps=3):
    """{"fwd"|"bwd": {kernel: device ms per call}}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    cin, cout, h, w = shape
    x, om_w, om_b, wt, bias, g = chip_smoke.make_fused_operands(
        7, batch, cin, cout, h, w, torch.device("cuda"))
    if small_offsets:
        om_w *= 0.02
        om_b *= 0.02
    calls = {"fwd": lambda: module.dcn_fused_forward(x, om_w, om_b, wt, bias),
             "bwd": lambda: module.dcn_fused_backward(x, om_w, om_b, wt, g)}
    out = {}
    for d, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        # the profiler now and then returns a cycle without device events;
        # such a profile is taken again
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            ms = {}
            for ev in prof.events():
                if (ev.device_type == torch.autograd.DeviceType.CUDA
                        and "dcn_" in ev.name):
                    name = ev.name.split("(")[0].split("<")[0].split(" ")[-1]
                    ms[name] = (ms.get(name, 0.0)
                                + ev.device_time_total / 1e3 / reps)
            if ms:
                break
        out[d] = ms
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write the times here")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("fused_dcn_ablation: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    print(chip_smoke.nvidia_smi(), flush=True)
    results = []
    modules = {name: load_variant(name, edits)
               for name, edits in VARIANTS.items()}
    for shape, batch in SHAPES:
        for small in (False, True):
            for name, module in modules.items():
                r = per_launch(module, shape, batch, small)
                results.append({"variant": name, "shape": shape,
                                "batch": batch, "small_offsets": small, **r})
                print(f"{name:17s} B={batch} {shape} "
                      f"{'offsets<1px' if small else 'offsets~2px'}: " +
                      " | ".join(f"{d} " + ", ".join(
                          f"{k.replace('dcn::dcn_', '')} {v:.3f}"
                          for k, v in ms.items()) +
                          f" = {sum(ms.values()):.3f} ms"
                          for d, ms in r.items() if d in ("fwd", "bwd")),
                      flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
