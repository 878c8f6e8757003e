"""Model FLOPs of one image's forward: the numerator of the bench's MFU.

    python -m centernet_uda_torch.utils.flops [backend] [size]

The counterpart of ``tools/flops_count.py``, on the port's own models. It
counts the model's math only: convolutions (transposed ones at their input
positions, the multiplications they really make), matrix products (``mm``,
``addmm``, ``bmm``, ``baddbmm``), each multiply-add as 2 FLOPs, with
``torch.utils.flop_counter.FlopCounterMode``. The DCN layers run the exact
op (``dcn_impl="xla"``), whose contraction (the (K*Cin) x Cout product of
every output pixel's sampled columns) is a visible ``bmm``, and whose
offset conv is a convolution. Bilinear sampling, BatchNorm, activations,
pooling and decode are not counted: they are the implementation's work,
not the model's, as in the JAX tool.

The forward runs on the ``meta`` device: shapes only, no arithmetic and
no memory, so a count at 512 px costs what building the model costs.

Why the port has a count of its own: the JAX tool's walk does not enter
the DCN layers (they run under ``remat``, whose ``jaxpr`` parameter has no
``.jaxpr`` attribute), so its 57.19 GFLOP/img for DLA-34 at 512 px leaves
out 14.19 GFLOP/img of DCN contraction; and its convolutions are those of
the TPU-only rewrites (the space-to-depth stem, the merged heads, the
lhs-dilated upsampling), not the port's. ``tests/test_torch_flops.py``
holds this count against the JAX model's, term by term.
"""

from __future__ import annotations

import sys
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from centernet_uda_torch import models as model_registry


def flop_counts(backend_name: str, size: int,
                **backend_params) -> Dict[str, Dict[str, int]]:
    """FLOPs of one ``size`` x ``size`` image's forward of the backend
    built with ``backend_params``, by module and op: ``{"Global": {op:
    flops}, "<Module>.<path>": {...}}``, the op names as strings (e.g.
    ``"aten.convolution"``, ``"aten.bmm"``). ``dcn_impl``, ``dtype`` and
    ``device`` are set here (the exact DCN op, float32, ``meta``)."""
    params = {**backend_params, "dcn_impl": "xla", "dtype": torch.float32,
              "device": "meta"}
    net = model_registry.build(backend_name, **params).module.eval()
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        net(torch.zeros(1, 3, size, size, device="meta"))
    return {module: {str(op): int(n) for op, n in ops.items()}
            for module, ops in counter.get_flop_counts().items()}


def forward_flops(backend_name: str, size: int, **backend_params) -> int:
    """Model FLOPs of one ``size`` x ``size`` image's forward."""
    return sum(flop_counts(backend_name, size,
                           **backend_params)["Global"].values())


def main(argv=None) -> int:
    from centernet_uda_torch.bench import BACKEND_PARAMS

    argv = sys.argv[1:] if argv is None else argv
    backend = argv[0] if argv else "dla"
    size = int(argv[1]) if len(argv) > 1 else 512
    flops = forward_flops(backend, size, **BACKEND_PARAMS[backend])
    print(f"{backend} {size}px forward: {flops / 1e9:.3f} GFLOP/img "
          "(convolutions and matrix products)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
