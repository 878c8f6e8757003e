"""The port's host library: target encoder, normalisation, COCO matcher.

Counterpart of ``centernet_uda_tpu/native/`` (its ``encoder.cpp`` and
ctypes loader), with the port's own source, ``csrc/host_encoder.cpp``, which
writes the port's layouts: the heatmap (C, H, W) and the normalised image
(3, H, W). The wrappers take what their plain versions take and return what
they return:

- ``gaussian_radius``, ``draw_gaussian``, ``encode_targets``: those of
  ``ops/gaussian.py`` (axis-aligned boxes; rotated boxes and keypoint
  targets stay in numpy, as in the JAX package);
- ``normalize_image``: ``data/coco.py:normalize_image`` (uint8 HWC to
  float32 CHW in one pass);
- ``coco_greedy_match``: ``evaluation/coco_eval_np.py:greedy_match``.

The library is compiled at first use with ``g++`` (``CXX_FLAGS``) into
``build/native/`` at the root of the checkout, under a name that carries a
hash of the source and the flags, and loaded with ``ctypes`` as a ``CDLL``,
so a call releases the interpreter lock and the loader's threads encode in
parallel. Nothing is compiled or loaded at import. A failed build raises
with the compiler's output: there is no fallback. The numpy versions run
only where a caller asks for them, through one switch:
``CENTERNET_DISABLE_NATIVE`` set in the environment (the JAX package's
switch), which ``enabled()`` reads and which the evaluator and a
``Dataset`` follow; ``Dataset(use_native_encoder=...)`` (the JAX
``Dataset``'s kwarg) overrides it for one dataset.

``CALLS`` counts the calls of each wrapper made in this process (not in a
loader's worker processes), so that a run can show that it went through the
library; ``reset_calls()`` sets the counts to 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "host_encoder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# no floating-point contraction: float32 expressions round as numpy's do
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
DISABLE_ENV = "CENTERNET_DISABLE_NATIVE"

CALLS: Dict[str, int] = {name: 0 for name in (
    "gaussian_radius", "draw_gaussian", "encode_targets", "normalize_image",
    "coco_greedy_match")}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_disabled_logged = False


def _new_lock_in_child() -> None:
    # a loader's worker process forks from a threaded parent, where another
    # thread may hold the lock at that instant
    global _lock
    _lock = threading.Lock()


os.register_at_fork(after_in_child=_new_lock_in_child)


def enabled() -> bool:
    """False where ``CENTERNET_DISABLE_NATIVE`` is set (to anything but an
    empty string); the first such answer is logged."""
    global _disabled_logged
    if not os.environ.get(DISABLE_ENV):
        return True
    if not _disabled_logged:
        _disabled_logged = True
        log.info("%s is set: the numpy target encoder, normalisation and "
                 "COCO matcher run", DISABLE_ENV)
    return False


def reset_calls() -> None:
    with _lock:
        for name in CALLS:
            CALLS[name] = 0


def _count(name: str) -> None:
    with _lock:
        CALLS[name] += 1


def lib_path(build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return Path(build_dir) / f"libhost_encoder-{digest.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR, cxx: str = "g++") -> Path:
    """Compile the library into ``build_dir`` unless it is there; returns
    its path. Raises ``RuntimeError`` with the compiler's output (or the
    reason it did not start) when the build fails."""
    path = lib_path(build_dir)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}."
                         f"{threading.get_ident()}.tmp.so")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        out = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"building the host library failed: {' '.join(cmd)}"
                           f": {exc}") from exc
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the host library failed: "
                           f"{' '.join(cmd)}\n{out.stdout}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The library, built and loaded on the first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build()
        lib = ctypes.CDLL(str(path))
        vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.cn_gaussian_radius.argtypes = [f64, f64, f64]
        lib.cn_gaussian_radius.restype = f64
        lib.cn_draw_gaussian.argtypes = [vp] + [i32] * 5
        lib.cn_draw_gaussian.restype = None
        lib.cn_encode_targets.argtypes = ([vp] * 3 + [i32] * 4 + [f64]
                                          + [vp] * 7)
        lib.cn_encode_targets.restype = None
        lib.cn_normalize_image.argtypes = [vp, vp, i32, i32, vp, vp]
        lib.cn_normalize_image.restype = None
        lib.cn_coco_greedy_match.argtypes = ([vp, i32, i32, vp, vp, vp, i32]
                                             + [vp] * 4)
        lib.cn_coco_greedy_match.restype = None
        _lib = lib
        log.info("host library loaded (%s)", path.name)
        return lib


def _ptr(arr: np.ndarray) -> int:
    return arr.ctypes.data


def gaussian_radius(det_size, min_overlap: float = 0.7) -> float:
    """CornerNet's minimum gaussian radius of a (height, width) box."""
    lib = load()
    _count("gaussian_radius")
    height, width = det_size
    return lib.cn_gaussian_radius(float(height), float(width),
                                  float(min_overlap))


def draw_gaussian(heatmap: np.ndarray, center, radius: int) -> np.ndarray:
    """Max-composite the truncated gaussian of ``radius`` at the integer
    ``center`` (x, y) into the float32 (H, W) ``heatmap`` in place."""
    if (heatmap.dtype != np.float32 or heatmap.ndim != 2
            or not heatmap.flags.c_contiguous):
        raise TypeError("draw_gaussian takes a C-contiguous float32 (H, W) "
                        f"heatmap, not {heatmap.dtype} {heatmap.shape}")
    height, width = heatmap.shape
    x, y = int(center[0]), int(center[1])
    if not (0 <= x < width and 0 <= y < height) or int(radius) < 0:
        raise ValueError(f"center {(x, y)} outside the {width} x {height} "
                         f"map or radius {radius} < 0")
    lib = load()
    _count("draw_gaussian")
    lib.cn_draw_gaussian(_ptr(heatmap), height, width, x, y, int(radius))
    return heatmap


def encode_targets(boxes: np.ndarray, classes, out_h: int, out_w: int,
                   num_classes: int, max_detections: int,
                   areas=None) -> dict:
    """``ops/gaussian.py:encode_targets`` in the library: the same
    arguments, the same arrays (``hm`` (C, out_h, out_w), ``wh``, ``reg``,
    ``ind`` int64, ``reg_mask`` uint8, ``gt_dets``, ``gt_areas``)."""
    boxes = np.ascontiguousarray(np.asarray(boxes, np.float32).reshape(-1, 4))
    classes = np.asarray(classes, np.int64).reshape(-1)
    n = min(len(boxes), len(classes), int(max_detections))
    if n and (classes[:n].min() < 0 or classes[:n].max() >= num_classes):
        raise ValueError(f"class ids {classes[:n].tolist()} outside "
                         f"[0, {num_classes})")
    area = np.full((n,), np.nan, np.float32)
    if areas is not None:
        for k, value in enumerate(list(areas)[:n]):
            if value is not None:
                area[k] = value
    k_max = int(max_detections)
    t = {
        "hm": np.zeros((num_classes, out_h, out_w), np.float32),
        "wh": np.zeros((k_max, 2), np.float32),
        "reg": np.zeros((k_max, 2), np.float32),
        "ind": np.zeros((k_max,), np.int64),
        "reg_mask": np.zeros((k_max,), np.uint8),
        "gt_dets": np.zeros((k_max, 6), np.float32),
        "gt_areas": np.zeros((k_max,), np.float32),
    }
    cls32 = np.ascontiguousarray(classes[:n], np.int32)
    lib = load()
    _count("encode_targets")
    lib.cn_encode_targets(
        _ptr(boxes), _ptr(cls32), _ptr(area), n, int(out_h), int(out_w),
        k_max, 0.7, _ptr(t["hm"]), _ptr(t["wh"]), _ptr(t["reg"]),
        _ptr(t["ind"]), _ptr(t["reg_mask"]), _ptr(t["gt_dets"]),
        _ptr(t["gt_areas"]))
    return t


def normalize_image(img: np.ndarray, mean, std) -> np.ndarray:
    """``(img / 255 - mean) / std`` of an (H, W, 3) uint8 image as a float32
    (3, H, W) array."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise TypeError("normalize_image takes an (H, W, 3) uint8 image, "
                        f"not {img.dtype} {img.shape}")
    img = np.ascontiguousarray(img)
    height, width = img.shape[:2]
    out = np.empty((3, height, width), np.float32)
    mean = np.ascontiguousarray(np.asarray(mean, np.float32).reshape(3))
    std = np.ascontiguousarray(np.asarray(std, np.float32).reshape(3))
    lib = load()
    _count("normalize_image")
    lib.cn_normalize_image(_ptr(img), _ptr(out), height, width, _ptr(mean),
                           _ptr(std))
    return out


def coco_greedy_match(ious: np.ndarray, gt_ignore: Sequence[bool],
                      gt_crowd: Sequence[bool], thrs: Sequence[float],
                      dt_out_of_range: Sequence[bool]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """COCO's greedy matching of one (image, category) cell at each of
    ``thrs``: ``(dtm, dt_ignore)``, (T, D) int64 and bool, as
    ``evaluation/coco_eval_np.py:greedy_match`` returns them. ``ious`` is
    (D, G), the ground truths ordered non-ignored first."""
    dt_out = np.ascontiguousarray(dt_out_of_range, np.uint8).reshape(-1)
    gt_ig = np.ascontiguousarray(gt_ignore, np.uint8).reshape(-1)
    crowd = np.ascontiguousarray(gt_crowd, np.uint8).reshape(-1)
    thrs = np.ascontiguousarray(thrs, np.float64).reshape(-1)
    num_dt, num_gt = len(dt_out), len(gt_ig)
    ious = np.ascontiguousarray(np.asarray(ious, np.float64)
                                .reshape(num_dt, num_gt))
    if len(crowd) != num_gt:
        raise ValueError(f"{len(crowd)} crowd flags for {num_gt} ground "
                         "truths")
    dtm = np.zeros((len(thrs), num_dt), np.uint8)
    dt_ig = np.zeros((len(thrs), num_dt), np.uint8)
    taken = np.zeros((max(num_gt, 1),), np.uint8)
    lib = load()
    _count("coco_greedy_match")
    lib.cn_coco_greedy_match(
        _ptr(ious), num_dt, num_gt, _ptr(gt_ig), _ptr(crowd), _ptr(thrs),
        len(thrs), _ptr(dt_out), _ptr(dtm), _ptr(dt_ig), _ptr(taken))
    return dtm.astype(np.int64), dt_ig.astype(bool)
