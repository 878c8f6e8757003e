"""Times of the explicit-offset DCN forward (rows 1, 2 and 6 of PERF.md)
under design variants of its shared body, ``csrc/dcn_sample_fwd.cuh``.

    python3 tools/fwd_dcn_variants.py [--json PATH]

Run from the root of a checkout on a machine with an NVIDIA H100. Each
variant is a copy of ``centernet_uda_torch/csrc`` with one edit, built
under ``build/ablation/`` (the three explicit forward sources only):

- ``tree``: the sources as they are (Cin split across blocks where the
  grid is short, chunks of 64 channels);
- ``no_cin_split``: the channel group narrows instead (each group gathers
  the sampled tile again), as the fused forward does;
- ``chunk32``: chunks of 32 channels (twice the barrier-closed steps);
- ``no_cin_split_chunk32``: both, the fused forward's design unchanged.

Every variant computes the same function. At each shape the wrappers of all
variants are timed with CUDA events, in turns (in order, then in reverse,
the two means averaged), and each one's output is held against the tree's
(atol 5e-2 * max(1, max|tree|), rtol 5e-2).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SPLIT_LOOP = r"while \(splits \* 2 <= chunks &&"
VARIANTS = {
    "tree": [],
    "no_cin_split": [("dcn_sample_fwd.cuh", SPLIT_LOOP,
                      "while (false && splits * 2 <= chunks &&")],
    "chunk32": [("dcn_sample_fwd.cuh", r"kFwdChunk = 64;",
                 "kFwdChunk = 32;")],
    "no_cin_split_chunk32": [
        ("dcn_sample_fwd.cuh", SPLIT_LOOP,
         "while (false && splits * 2 <= chunks &&"),
        ("dcn_sample_fwd.cuh", r"kFwdChunk = 64;", "kFwdChunk = 32;")],
}
# (wrapper, dtype, (batch, cin, cout, h, w)): row 6 at MobileNetV2's train
# and eval shapes, row 1 at DLA-34's widest and its 16 px layer (Cin
# split), row 2 at the 1088 px eval's layers
CASES = [
    ("dcn_sel_forward", "float32", (32, 1280, 256, 16, 16)),
    ("dcn_sel_forward", "bfloat16", (32, 1280, 256, 16, 16)),
    ("dcn_sel_forward", "float32", (4, 1280, 256, 25, 25)),
    ("dcn_sel_forward", "bfloat16", (4, 1280, 256, 25, 25)),
    ("dcn_forward", "float32", (16, 64, 64, 128, 128)),
    ("dcn_forward", "float32", (16, 512, 256, 16, 16)),
    ("dcn_wide_forward", "float32", (4, 64, 64, 272, 272)),
]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write the times here")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("fwd_dcn_variants: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_smoke
    from fused_dcn_ablation import load_variant

    print(chip_smoke.nvidia_smi(), flush=True)
    modules = {name: load_variant(name, edits, ("dcn_fwd", "dcn_sel_fwd",
                                                "dcn_wide_fwd"))
               for name, edits in VARIANTS.items()}
    device = torch.device("cuda")
    results = []
    for fn, dtype, (b, cin, cout, h, w) in CASES:
        x, off, m, wt, bias, _ = chip_smoke.make_operands(
            11, b, cin, cout, h, w, device)
        dt = getattr(torch, dtype)
        x, wt = x.to(dt), wt.to(dt)
        calls = {name: (lambda mod=mod: getattr(mod, fn)(x, off, m, wt, bias))
                 for name, mod in modules.items()}
        ref = calls["tree"]()
        for name, call in calls.items():
            chip_smoke.compare(f"{name} {fn}", call(), ref)
        order = list(calls)
        first = {name: chip_smoke.time_ms(calls[name]) for name in order}
        second = {name: chip_smoke.time_ms(calls[name])
                  for name in reversed(order)}
        ms = {name: (first[name] + second[name]) / 2 for name in order}
        results.append({"wrapper": fn, "dtype": dtype,
                        "shape": [b, cin, cout, h, w], "ms": ms})
        print(f"{fn} {dtype} B={b} {cin}->{cout} @{h}x{w}: " + ", ".join(
            f"{name} {t:.4f}" for name, t in ms.items()) + " ms", flush=True)
        del x, off, m, wt, bias, ref
        torch.cuda.empty_cache()
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
