"""Depthwise convolutions of float32 NCHW maps: torch's own forward, and a
backward of hand-written Hopper kernels (``csrc/depthwise_bwd.cu``) with
their plain twin.

``models.common.Conv2d`` (through ``ops.conv.conv2d``) and ``SameConv2d``
send a conv that ``takes_kernel`` accepts to ``depthwise_conv2d``, a
``torch.autograd.Function``:

- forward: ``F.conv2d`` as the layer called it before (ATen's own
  depthwise kernel on the card), so the output is the same bits; it saves
  x and the weight, as ATen's convolution does;
- backward: ``depthwise_bwd_kernel`` reads g and x once, writes dx and
  per-tile sums of d(weight) (the tiles sized from the shape by ``plan``,
  so that every layer launches a few waves of blocks whatever its channel
  count and map size), and ``depthwise_bwd_finalize_kernel`` adds each
  (channel, tap)'s tile sums in tile order into d(weight).

The rule reads only what the call can observe: the conv is depthwise
(``groups`` = C_in = C_out > 1, a (C, 1, k, k) weight, k 3 or 5, stride 1
or 2 both ways, dilation 1, zero padding under k), float32, on a CUDA
device, contiguous NCHW, and a gradient is to be taken. Every other conv
keeps ATen or cuDNN: groups = 1, bf16, the CPU, and any call under
``no_grad`` (eval).

No float is added by an atomic: each call gives the same bits on every
run. The wrapper allocates with ``torch.empty`` (the tile sums' workspace
sized from the shape alone) and launches on the current stream without a
host sync, so that a CUDA graph may capture them (``utils/graphs.py``).
The plain twin (``backward_plain``) computes the same sums with PyTorch's
ops, one strided slice a tap: the backward takes it for a CPU tensor, and
the tests hold the kernels against it. ``LAUNCHES`` counts each kernel's
launches by the wrapper (``utils/graphs.py`` adds a captured graph's on
each replay).

The source is compiled with ``nvcc`` at first use, as ``ops.dcn_cuda``
compiles the DCN kernels (same flags, same build directory, a name that
carries a hash of the source), and loaded with ``ctypes``; nothing is
compiled or loaded at import.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from centernet_uda_torch.ops import dcn_cuda

NAME = "depthwise_bwd"
SOURCE = dcn_cuda.CSRC / "depthwise_bwd.cu"

LAUNCHES: Dict[str, int] = {
    "depthwise_bwd_kernel": 0, "depthwise_bwd_finalize_kernel": 0}

KERNEL_SIZES = (3, 5)
STRIDES = (1, 2)

_THREADS = 256  # a block's threads (csrc/depthwise_bwd.cu: kThreads)
# the tile kernel's grid: about this many blocks (a few waves of 132 SMs
# at two or three resident blocks each), no tile of fewer than _MIN_ROWS
# cell rows (or the whole plane), at least _MIN_TPP threads a plane, and a
# block's g tile in the 48 KB of shared memory a launch gets by default;
# over b3's 26 shapes (batch 8, 512 px) on an H100 the step's backward
# took 2.23 ms at these, 2.24-2.25 at 2048 and 4096 blocks, 2.34 at 16
# rows and 2.63 at 8 (PERF.md, the depthwise backward's plans)
_TARGET_BLOCKS = 1024
_MIN_ROWS = 32
_MIN_TPP = 8
_SMEM_BYTES = 48 * 1024

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def cells(size: int, pad: int, stride: int) -> Tuple[int, int]:
    """(first, count) of the cells along one dim: cell i holds the input
    positions ``stride * i + a - pad`` (0 <= a < stride) inside the map."""
    first = pad // stride
    return first, (size - 1 + pad) // stride + 1 - first


def plan(n: int, c: int, h: int, w: int, k: int, stride: int, ph: int,
         pw: int) -> Optional[Tuple[int, int, int]]:
    """(log2 of the threads a plane, cell rows a tile, row tiles) of the
    tile kernel's grid for an (n, c, h, w) map, or None where one cell row
    of a block's planes does not fit its shared memory."""
    halo = (k - 1) // stride
    _, rows_all = cells(h, ph, stride)
    _, cols = cells(w, pw, stride)
    tpp = min(_THREADS, max(_MIN_TPP, 1 << (cols - 1).bit_length()))
    per_block = _THREADS // tpp
    fit = _SMEM_BYTES // (4 * per_block * (cols + halo)) - halo
    if fit < 1:
        return None
    groups = -(-n * c // per_block)
    wanted = -(-_TARGET_BLOCKS // groups)
    rows = max(min(rows_all, _MIN_ROWS), -(-rows_all // wanted))
    rows = min(rows, fit, rows_all)
    tiles = -(-rows_all // rows)
    return tpp.bit_length() - 1, -(-rows_all // tiles), tiles


def _on_card(x) -> bool:
    return x.is_cuda


def takes_kernel(x, weight, stride, padding, dilation, groups) -> bool:
    """Whether a conv runs ``depthwise_conv2d``: depthwise (``groups`` =
    C_in = C_out > 1, weight (C, 1, k, k) with k in ``KERNEL_SIZES``),
    stride in ``STRIDES`` both ways, dilation 1, zero padding under k each
    way; float32, on a CUDA device, contiguous NCHW, its elements countable
    in 31 bits; a gradient to be taken."""
    if isinstance(padding, str) or x.dim() != 4 or weight.dim() != 4:
        return False
    (sh, sw), (ph, pw), (dh, dw) = (_pair(stride), _pair(padding),
                                    _pair(dilation))
    n, c, h, w = x.shape
    cout, per_group, kh, kw = weight.shape
    return (_on_card(x) and x.dtype == weight.dtype == torch.float32
            and groups == c == cout > 1 and per_group == 1
            and kh == kw and kh in KERNEL_SIZES and sh == sw
            and sh in STRIDES and (dh, dw) == (1, 1)
            and 0 <= ph < kh and 0 <= pw < kw
            and h + 2 * ph >= kh and w + 2 * pw >= kw
            and x.is_contiguous() and weight.is_contiguous()
            and 0 < x.numel() < 2 ** 31
            and plan(n, c, h, w, kh, sh, ph, pw) is not None
            and torch.is_grad_enabled()
            and (x.requires_grad or weight.requires_grad))


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
    lib.depthwise_bwd.argtypes = [vp] * 6 + [i32] * 11 + [vp]
    lib.depthwise_bwd.restype = i32
    lib.depthwise_error_string.argtypes = [i32]
    lib.depthwise_error_string.restype = ctypes.c_char_p
    _LIBS[NAME] = lib
    return lib


def _raise_on(err: int) -> None:
    if err != 0:
        msg = _lib().depthwise_error_string(err).decode()
        raise RuntimeError(f"{NAME} launch failed: CUDA error {err} ({msg})")


def _backward_launch(x, g, weight, stride: int, padding: Tuple[int, int],
                     stream: int):
    """One backward call for checked operands: (dx, d(weight))."""
    n, c, h, w = x.shape
    k = weight.shape[-1]
    ph, pw = padding
    tpp_log2, rows, tiles = plan(n, c, h, w, k, stride, ph, pw)
    dx = torch.empty_like(x)
    part = torch.empty((n * tiles, c, k, k), dtype=torch.float32,
                       device=x.device)
    dweight = torch.empty_like(weight)
    err = _lib().depthwise_bwd(
        x.data_ptr(), g.data_ptr(), weight.data_ptr(),
        dx.data_ptr(), part.data_ptr(),
        dweight.data_ptr(), n, c, h, w, k, stride, ph, pw, tpp_log2, rows,
        tiles, stream)
    _raise_on(err)
    LAUNCHES["depthwise_bwd_kernel"] += 1
    LAUNCHES["depthwise_bwd_finalize_kernel"] += 1
    return dx, dweight


def backward_plain(x, g, weight, stride, padding
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: (dx, d(weight)) of a
    depthwise conv of ``x`` (N, C, H, W) with ``weight`` (C, 1, k, k),
    from its output's gradient ``g``; one strided slice of the padded map
    a tap."""
    n, c, h, w = x.shape
    k = weight.shape[-1]
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    ho, wo = g.shape[2:]
    padded = F.pad(x, (pw, pw, ph, ph))
    dpadded = torch.zeros_like(padded)
    taps = weight.reshape(c, k, k)
    dweight = torch.empty((c, k, k), dtype=x.dtype, device=x.device)
    for ky in range(k):
        for kx in range(k):
            at = (slice(None), slice(None),
                  slice(ky, ky + sh * (ho - 1) + 1, sh),
                  slice(kx, kx + sw * (wo - 1) + 1, sw))
            dweight[:, ky, kx] = (g * padded[at]).sum((0, 2, 3))
            dpadded[at] += g * taps[:, ky, kx].view(1, c, 1, 1)
    return dpadded[:, :, ph:ph + h, pw:pw + w], dweight.view_as(weight)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def depthwise_backward(x, g, weight, stride, padding):
    """(dx, d(weight)): the kernels on a CUDA map, the twin on a CPU
    one."""
    if not x.is_cuda:
        return backward_plain(x, g, weight, stride, padding)
    g = g.contiguous()
    with torch.cuda.device(x.device):
        return _backward_launch(x, g, weight, _pair(stride)[0],
                                _pair(padding), _stream(x))


class _DepthwiseConvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding)
        return F.conv2d(x, weight, None, stride, padding, 1, x.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dweight = depthwise_backward(x, g, weight, *ctx.conf)
        need_x, need_weight = ctx.needs_input_grad[:2]
        return (dx if need_x else None, dweight if need_weight else None,
                None, None)


def depthwise_conv2d(x: torch.Tensor, weight: torch.Tensor, stride,
                     padding) -> torch.Tensor:
    """``F.conv2d(x, weight, None, stride, padding, 1, C)``, its output
    torch's own, differentiable in x and the weight through the backward
    kernels (the twin on the CPU)."""
    return _DepthwiseConvFn.apply(x, weight, stride, padding)
