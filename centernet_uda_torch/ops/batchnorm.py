"""Train-mode BatchNorm of float32 NCHW maps: torch's own forward, and a
backward of hand-written Hopper kernels (``csrc/bn_train.cu``) with their
plain twin.

``models.common.BatchNorm2d`` takes its running statistics with
``torch.var_mean`` and, for an input that ``takes_kernel`` accepts (a CUDA
float32 map, contiguous NCHW), normalises and back-propagates through
``batch_norm_train``, a ``torch.autograd.Function``:

- forward: torch's train-mode batch norm (``torch._batch_norm_impl_index``,
  what ``F.batch_norm`` calls: cuDNN's ``bn_fw_tr_1C11`` on the card), so
  the output is the same bits as ``F.batch_norm`` gives; it saves x, the
  mean and invstd that the forward took, and the weight, never y (DLA-34's
  ReLU overwrites y in place);
- backward: ``bn_train_reduce_kernel`` sums dy and dy * (x - mean) over
  slices of each channel (the slices sized from the shape by
  ``reduce_split``, so that every layer launches a few waves of blocks
  whatever its channel count), ``bn_train_finalize_kernel`` adds each
  channel's slices in slice order into d(weight) and d(bias), and, where x
  takes a gradient, ``bn_train_dx_kernel`` writes dx.

No float is added by an atomic: each call gives the same bits on every
run. The wrapper allocates with ``torch.empty`` (the slices' workspace
sized from the shape alone) and launches on the current stream without a
host sync, so that a CUDA graph may capture them (``utils/graphs.py``).
The plain twin (``backward_plain``) computes the same formulas with
PyTorch's ops: the backward takes it for a CPU tensor, and the tests hold
the kernels against it. ``LAUNCHES`` counts each kernel's launches by the
wrapper (``utils/graphs.py`` adds a captured graph's on each replay).

The source is compiled with ``nvcc`` at first use, as ``ops.dcn_cuda``
compiles the DCN kernels (same flags, same build directory, a name that
carries a hash of the source), and loaded with ``ctypes``; nothing is
compiled or loaded at import.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from centernet_uda_torch.ops import dcn_cuda

NAME = "bn_train"
SOURCE = dcn_cuda.CSRC / "bn_train.cu"

LAUNCHES: Dict[str, int] = {
    "bn_train_reduce_kernel": 0, "bn_train_finalize_kernel": 0,
    "bn_train_dx_kernel": 0}

# the reduce kernel's grid: about this many blocks (a few waves of 132 SMs
# at four resident blocks each), none of fewer than _MIN_SLICE vectors
_REDUCE_TARGET_BLOCKS = 2048
_MIN_SLICE = 1024

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def takes_kernel(x: torch.Tensor) -> bool:
    """Whether a train-mode BatchNorm input of one statistics group runs
    the backward kernels: float32, contiguous NCHW, on a CUDA device, not
    empty, its elements countable in 31 bits and its channels in one grid
    dimension. Any other input keeps ATen's ``F.batch_norm`` (cuDNN on the
    card)."""
    return (x.is_cuda and x.dtype == torch.float32 and x.dim() == 4
            and x.is_contiguous() and 0 < x.numel() < 2 ** 31
            and x.shape[1] <= 65535)


def _lib_path() -> Path:
    return dcn_cuda.library_path(NAME, [SOURCE])


def build_kernel() -> Dict[str, str]:
    """Compile the source if it has no library yet: ``{NAME: the
    compiler's output}`` if it built, else ``{}``
    (``dcn_cuda.build_libraries``)."""
    return dcn_cuda.build_libraries({NAME: (SOURCE, _lib_path())})


def _lib() -> ctypes.CDLL:
    if NAME in _LIBS:
        return _LIBS[NAME]
    path = _lib_path()
    if not path.exists():
        build_kernel()
    lib = ctypes.CDLL(str(path))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bn_train_bwd.argtypes = ([vp] * 6 + [i32, i32] + [vp] * 3
                                 + [i32] * 4 + [vp])
    lib.bn_train_bwd.restype = i32
    lib.bn_train_error_string.argtypes = [i32]
    lib.bn_train_error_string.restype = ctypes.c_char_p
    _LIBS[NAME] = lib
    return lib


def _raise_on(err: int) -> None:
    if err != 0:
        msg = _lib().bn_train_error_string(err).decode()
        raise RuntimeError(f"{NAME} launch failed: CUDA error {err} ({msg})")


def _vector(*tensors: torch.Tensor) -> int:
    """4 where every map's planes hold whole 16-byte vectors (H * W a
    multiple of 4, the pointers 16-byte aligned), else 1."""
    hw = tensors[0].shape[2] * tensors[0].shape[3]
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return 4 if hw % 4 == 0 and aligned else 1


def reduce_split(n: int, c: int, hw: int) -> Tuple[int, int]:
    """(slices, vectors a slice) of the reduce kernel's grid for a map of
    ``n`` samples, ``c`` channels and ``hw`` vectors a plane: about
    ``_REDUCE_TARGET_BLOCKS`` blocks in all, each slice at least
    ``_MIN_SLICE`` vectors (or the whole channel), none empty."""
    count = n * hw
    wanted = max(1, -(-_REDUCE_TARGET_BLOCKS // c))
    slice_ = max(min(_MIN_SLICE, count), -(-count // wanted))
    return -(-count // slice_), slice_


def _backward_launch(x, dy, mean, invstd, weight, need_dx: bool,
                     stream: int):
    """One backward call for checked operands: (dx or None, d(weight),
    d(bias))."""
    n, c, h, w = x.shape
    dx = torch.empty_like(x) if need_dx else None
    v = _vector(*[t for t in (x, dy, dx) if t is not None])
    slices, slice_ = reduce_split(n, c, h * w // v)
    part = torch.empty((2, slices, c), dtype=torch.float32, device=x.device)
    dweight = torch.empty_like(weight)
    dbias = torch.empty_like(weight)
    err = _lib().bn_train_bwd(
        x.data_ptr(), dy.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
        weight.data_ptr(), part.data_ptr(), slices, slice_,
        dweight.data_ptr(), dbias.data_ptr(),
        None if dx is None else dx.data_ptr(), n, c, h * w // v, v, stream)
    _raise_on(err)
    LAUNCHES["bn_train_reduce_kernel"] += 1
    LAUNCHES["bn_train_finalize_kernel"] += 1
    LAUNCHES["bn_train_dx_kernel"] += int(need_dx)
    return dx, dweight, dbias


def _per_channel(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1, 1, 1)


def backward_plain(x, dy, mean, invstd, weight
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: (dx, d(weight), d(bias))."""
    centred = x - _per_channel(mean)
    dbias = dy.sum((0, 2, 3))
    dweight = (dy * centred).sum((0, 2, 3)) * invstd
    count = x.numel() // x.shape[1]
    slope = dweight * invstd / count
    dx = _per_channel(weight * invstd) * (
        dy - _per_channel(dbias / count) - centred * _per_channel(slope))
    return dx, dweight, dbias


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def batch_norm_forward(x, weight, bias, eps: float):
    """(y, mean, invstd): torch's train-mode batch norm of ``x`` without
    running statistics, and the batch mean and invstd it normalised
    with."""
    y, mean, invstd, _, _ = torch._batch_norm_impl_index(
        x, weight, bias, None, None, True, 0.0, eps,
        torch.backends.cudnn.enabled)
    return y, mean, invstd


def batch_norm_backward(x, dy, mean, invstd, weight, need_dx: bool = True):
    """(dx or None, d(weight), d(bias)): the kernels on a CUDA map, the
    twin on a CPU one."""
    if not x.is_cuda:
        dx, dweight, dbias = backward_plain(x, dy, mean, invstd, weight)
        return (dx if need_dx else None), dweight, dbias
    dy = dy.contiguous()
    with torch.cuda.device(x.device):
        return _backward_launch(x, dy, mean, invstd, weight, need_dx,
                                _stream(x))


class _BatchNormTrainFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, invstd = batch_norm_forward(x, weight, bias, eps)
        ctx.save_for_backward(x, mean, invstd, weight)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, invstd, weight = ctx.saved_tensors
        dx, dweight, dbias = batch_norm_backward(
            x, dy, mean, invstd, weight, ctx.needs_input_grad[0])
        return dx, dweight, dbias, None


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Train-mode BatchNorm of ``x`` with its batch statistics, the output
    torch's own, differentiable in x, the weight and the bias through the
    backward kernels."""
    return _BatchNormTrainFn.apply(x, weight, bias, eps)
