"""Model export: serving artifacts from a trained experiment.

    python -m centernet_uda_torch.export -e <experiment> [-i W H]
        [-l last|best] [-wd] [-b N] [--nms K] [--max-detections N]
        [--formats pt2 opt] [--outputs-dir DIR] [--device cuda|cpu]

Counterpart of ``centernet_uda_tpu/export.py`` (the reference's ONNX
export, ``export.py:86-132``), with ``torch.export`` in place of
``jax.export``:

- ``pt2``: the serving module traced by ``torch.export.export`` at a fixed
  ``(batch, 3, H, W)`` float32 NCHW input and written by
  ``torch.export.save`` as ``centernet_<backend>_<H>x<W>[_wd].pt2``;
- ``opt``: the same program after ``run_decompositions()`` (core ATen
  operators), as ``<name>.opt.pt2``; the counterpart of the JAX package's
  optimized HLO (``opthlo``) and of the reference's simplified ONNX.

The TensorFlow SavedModel of the JAX package is left out: it needs
TensorFlow and ``jax2tf``.

The serving module is the reference's ``CenterNet`` wrapper
(``export.py:19-56``): backend forward, ``sigmoid_clamped`` heatmap,
``decode_detections``, boxes times ``down_ratio`` (the angle column of a
rotated box is not scaled; keypoints are), returning ``(boxes, scores,
classes[, keypoints])``; ``--without-decode`` (``-wd``) exports the raw
head dict. It computes in float32, as the JAX export builds its backend
without ``precision``. A DCN layer on the kernel path appears in the graph
as its ``centernet_uda::*`` op (``ops/dcn_cuda.py``), so an artifact run on
the card launches the Hopper kernels; ``load_artifact`` registers the ops
before it loads one, and a fresh process serves an artifact with it::

    from centernet_uda_torch.export import load_artifact
    program = load_artifact("outputs/baseline/centernet_dla_512x512.pt2")
    boxes, scores, classes = program.module()(images)

The CLI reads ``outputs/<experiment>/config.yaml`` and
``model_<last|best>.ckpt`` as the port's ``train.main`` writes them, and
writes the artifacts beside them. It runs on the card unless ``--device``
says ``cpu``.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union

import torch
import torch.nn as nn

from centernet_uda_torch import config as config_lib
from centernet_uda_torch import models as model_registry
from centernet_uda_torch import resolve_device
from centernet_uda_torch.models.common import Backend
from centernet_uda_torch.ops.decode import decode_detections
from centernet_uda_torch.ops.tensor import sigmoid_clamped
from centernet_uda_torch.utils import checkpoint as ckpt

log = logging.getLogger("export")

FORMATS = ("pt2", "opt")


def build_model(cfg, checkpoint_path, device="cuda") -> Backend:
    """The config's backend at float32, its weights restored from
    ``checkpoint_path``, in eval mode (the JAX ``build_model``)."""
    device = resolve_device(device)
    if not Path(checkpoint_path).exists():
        raise FileNotFoundError(f"no checkpoint at {checkpoint_path}")
    params = cfg.model.backend.params.to_dict()
    params.setdefault("dcn_impl", str(cfg.get("dcn_impl", "auto")))
    if params.get("pretrained"):
        # the checkpoint holds every weight, the trunk's too
        params["pretrained"] = None
    backend = model_registry.build(cfg.model.backend.name, **params,
                                   seed=int(cfg.get("seed", 42)),
                                   dtype=torch.float32, device=device)
    ckpt.load_checkpoint(checkpoint_path, backend.module,
                         backend_name=backend.name)
    backend.module.eval()
    return backend


class ServingModule(nn.Module):
    """(batch, 3, H, W) float32 images -> ``(boxes, scores, classes[,
    keypoints])`` in input pixels, or the raw head dict without decode (the
    JAX ``make_serving_fn``). Boxes are (batch, k, 4) ``[x1, y1, x2, y2]``
    or, rotated, (batch, k, 5) ``[cx, cy, w, h, angle]``; scores and classes
    (batch, k); keypoints (batch, k, P, 2)."""

    def __init__(self, backend: Backend, max_detections: int = 100,
                 with_decode: bool = True, nms_size: int = 3):
        super().__init__()
        self.net = backend.module
        self.rotated = bool(backend.rotated_boxes)
        self.down_ratio = int(backend.down_ratio)
        self.max_detections = int(max_detections)
        self.with_decode = bool(with_decode)
        self.nms_size = int(nms_size)
        self.eval()

    def forward(self, x: torch.Tensor
                ) -> Union[Dict[str, torch.Tensor], Tuple[torch.Tensor, ...]]:
        outputs = self.net(x)
        if not self.with_decode:
            return outputs
        dets = decode_detections(
            sigmoid_clamped(outputs["hm"]), outputs["wh"],
            outputs.get("reg"), kps=outputs.get("kps"),
            k=self.max_detections, rotated=self.rotated,
            nms_size=self.nms_size)
        kps = None
        if isinstance(dets, tuple):
            dets, kps = dets
        if self.rotated:
            # the angle column (degrees) is not scaled
            boxes = torch.cat([dets[..., :4] * self.down_ratio,
                               dets[..., 4:5]], dim=-1)
        else:
            boxes = dets[..., :4] * self.down_ratio
        served = (boxes, dets[..., -2], dets[..., -1])
        if kps is not None:
            served += (kps * self.down_ratio,)
        return served


def export_program(serving: nn.Module, input_shape: Sequence[int]
                   ) -> torch.export.ExportedProgram:
    """``torch.export`` of ``serving`` at a fixed float32 input shape, on
    the device of its parameters."""
    device = next(serving.parameters()).device
    example = torch.zeros(tuple(input_shape), dtype=torch.float32,
                          device=device)
    return torch.export.export(serving, (example,))


def export_pt2(program: torch.export.ExportedProgram, out_path: Path
               ) -> Path:
    """Write ``program`` as ``<out_path>.pt2``."""
    path = Path(out_path).with_suffix(".pt2")
    torch.export.save(program, str(path))
    log.info("wrote %s (%d bytes)", path, path.stat().st_size)
    return path


def export_opt(program: torch.export.ExportedProgram, out_path: Path
               ) -> Path:
    """Write ``program`` decomposed to core ATen operators (the DCN ops
    kept) as ``<out_path>.opt.pt2``."""
    path = Path(out_path).with_suffix(".opt.pt2")
    torch.export.save(program.run_decompositions(), str(path))
    log.info("wrote %s (%d bytes, core ATen)", path, path.stat().st_size)
    return path


def load_artifact(path) -> torch.export.ExportedProgram:
    """Load an artifact written by this module; call ``.module()`` on the
    result to serve it. Registers the DCN ops first (importing
    ``ops.dcn_cuda``), so a process that imported nothing else of the port
    can load and run it, and turns TF32 off in matmuls and cuDNN
    convolutions: the artifact computes in float32, as ``build_trainer``
    has the port's float32 mean float32 (cuDNN's default is TF32)."""
    from centernet_uda_torch.ops import dcn_cuda  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.export.load(str(path))


def artifact_name(cfg, input_size: Sequence[int], with_decode: bool) -> str:
    """``centernet_<backend>_<H>x<W>[_wd]`` for ``input_size`` (W, H)."""
    w, h = int(input_size[0]), int(input_size[1])
    name = f"centernet_{cfg.model.backend.name}_{h}x{w}"
    return name if with_decode else name + "_wd"


def export_model(cfg, checkpoint_path, input_size: Sequence[int],
                 max_detections: int, with_decode: bool, nms_size: int,
                 batch_size: int = 1, formats: Sequence[str] = ("pt2",),
                 out_dir=".", device="cuda") -> List[Path]:
    """Build, restore, trace and write the artifacts of ``formats``;
    returns their paths."""
    unknown = set(formats) - set(FORMATS)
    if unknown:
        raise ValueError(f"unknown export formats {sorted(unknown)}; "
                         f"available: {list(FORMATS)}")
    backend = build_model(cfg, checkpoint_path, device)
    serving = ServingModule(backend, max_detections, with_decode, nms_size)
    w, h = int(input_size[0]), int(input_size[1])
    program = export_program(serving, (int(batch_size), 3, h, w))
    base = Path(out_dir) / artifact_name(cfg, input_size, with_decode)
    artifacts = []
    if "pt2" in formats:
        artifacts.append(export_pt2(program, base))
    if "opt" in formats:
        artifacts.append(export_opt(program, base))
    return artifacts


def main(argv=None) -> List[Path]:
    parser = argparse.ArgumentParser(
        prog="python -m centernet_uda_torch.export",
        description="Export a trained experiment for serving "
                    "(torch.export). The JAX package's TensorFlow "
                    "SavedModel format is not offered: it needs TensorFlow.")
    parser.add_argument("-e", "--experiment", required=True,
                        help="experiment name (reads outputs/<e>/config.yaml)")
    parser.add_argument("-i", "--input-size", type=int, nargs=2,
                        default=[512, 512], metavar=("W", "H"))
    parser.add_argument("-l", "--load", choices=["last", "best"],
                        default="last")
    parser.add_argument("-wd", "--without-decode", action="store_true",
                        help="export raw head outputs (no decode)")
    parser.add_argument("-b", "--batch-size", type=int, default=1)
    parser.add_argument("--nms", type=int, default=3, help="peak-NMS window")
    parser.add_argument("--max-detections", type=int, default=100)
    parser.add_argument("--formats", nargs="+", default=["pt2"],
                        choices=list(FORMATS),
                        help="pt2: the traced program; opt: decomposed to "
                             "core ATen operators (.opt.pt2)")
    parser.add_argument("--outputs-dir", default="outputs")
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)

    exp_dir = Path(args.outputs_dir) / args.experiment
    cfg = config_lib.load_composed(str(exp_dir / "config.yaml"))
    return export_model(
        cfg, exp_dir / f"model_{args.load}.ckpt", args.input_size,
        args.max_detections, not args.without_decode, args.nms,
        args.batch_size, tuple(args.formats), str(exp_dir), args.device)


if __name__ == "__main__":
    main()
