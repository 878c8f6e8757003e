"""CenterNet-UDA in PyTorch for NVIDIA Hopper (H100).

The PyTorch/CUDA counterpart of ``centernet_uda_tpu``. It imports ``torch``,
``numpy`` and ``yaml`` only; it keeps its own copy of everything it needs
from the JAX package and reads the same ``configs/`` tree.

Layout. Every public function and module takes and returns NCHW tensors,
the layout of ``nn.Conv2d``/``BatchNorm2d`` and of the reference's ``.pth``
checkpoints: images (B, 3, H, W); head maps (B, C, H/4, W/4); DCN offsets
(B, 18, H, W) with channel 2t = dy and 2t+1 = dx of tap t, masks
(B, 9, H, W). Targets keep the data pipeline's layout: ``hm`` (B, C, h, w),
``ind``/``reg_mask`` (B, K), ``wh``/``reg`` (B, K, 2). The DCN kernels stage
x channels-last internally. (The JAX package is NHWC; the tests transpose
at the boundary.) Parameter names reproduce the reference state-dict keys.

Devices. The entry points (``train.build_trainer``, ``uda.base.Model``,
``models.build``) take ``device`` and default to ``"cuda"``; without a card
that default raises instead of running on the CPU. Pass ``device="cpu"`` to
run on the CPU, as the tests do.

Precision. ``precision: float32`` means float32: building a trainer sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``. ``precision: bfloat16`` follows
the JAX package's ``dtype=bfloat16``: every layer computes in bf16 (an
explicit compute dtype per module, not ``torch.autocast``, so the CPU and
the card run the same arithmetic), parameters, BatchNorm statistics, the
heads' outputs, the loss and the optimizer stay float32, and each DCN layer
runs the fused bf16 kernels (the offset conv inside). TF32 stays off.

DCN implementation (config key ``dcn_impl``): ``auto`` runs the hand-written
Hopper kernels (``ops/dcn_cuda.py``) on CUDA tensors and the exact op on CPU
tensors; ``cuda`` runs the kernel path (on a CPU tensor, its plain twin);
``xla`` runs the exact op; ``pallas`` is read as ``cuda``. The kernels clamp
the vertical offset to +-14 px; once a monitored layer reaches the clamp the
trainer switches to the exact op, loudly (``Model.maybe_degrade_dcn``).

Serving: ``export.py`` writes ``torch.export`` artifacts whose DCN layers
are the custom ops ``centernet_uda::*`` of ``ops/dcn_cuda.py``. Data
parallelism: ``parallel/ddp.py``, one process per device (``torchrun``, or
``train.main`` for ``mesh: {data: N}`` / ``gpu: [...]``), NCCL on cards and
gloo on the CPU.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return device
