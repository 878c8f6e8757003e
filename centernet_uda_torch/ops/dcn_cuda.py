"""Hand-written Hopper (sm_90a) kernels of the DCNv2 layer, and their build.

Seven kernel sources, CUDA C++ in ``centernet_uda_torch/csrc/``. Every
forward runs the tensor-core sampling forward of ``dcn_sample_fwd.cuh``
(per 8 x 8 pixel tile: sampling tables, 16-byte corner gathers into a
shared tile, ``mma.sync`` with W), a template over the geometry: the
explicit layer's offset and mask tensors, or the fused layer's offset conv,
computed per tile by ``dcn_fused.cuh``. Every backward runs the tensor-core
sampling kernels of ``dcn_sample_bwd.cuh`` (a data kernel for dx and the
sampling gradients, a split-K weight kernel for dW) over the same two
geometries. All the inline PTX (``ldmatrix``, ``mma.sync``, ``cp.async``,
vector reductions) is in ``dcn_mma.cuh``:

- ``dcn_fwd`` (``csrc/dcn_fwd.cu``, one launch), the float32 layer's
  forward, replaces the TPU kernel ``_dcn_kernel``
  (``centernet_uda_tpu/ops/dcn_pallas.py``, via ``dcn_v2_pallas_lanes``).
- ``dcn_bwd`` (``csrc/dcn_bwd.cu``, two launches: sampling gradients + dx,
  then dW, on the tensor cores; g rounded to bf16 once by the wrapper, as
  the TPU kernel rounds it) replaces ``_dcn_bwd_params_kernel`` (same file,
  via ``_bwd_params_call`` / ``dcn_v2_pallas_bwd_lanes``).
- ``dcn_fused_fwd`` (``csrc/dcn_fused_fwd.cu``, one launch: the offset
  conv, sampling and contraction of a pixel tile), the bfloat16 layer's
  forward with its offset conv inside, replaces ``_dcn_fused_kernel`` (via
  ``dcn_v2_pallas_lanes_fused``).
- ``dcn_fused_bwd`` (``csrc/dcn_fused_bwd.cu``, four launches: om
  recompute, sampling data, dW with dW_om and db_om, dx from dz) replaces
  ``_dcn_fused_bwd_kernel`` (via ``dcn_v2_pallas_bwd_lanes_fused``).
- ``dcn_sel_fwd`` (``csrc/dcn_sel_fwd.cu``, one launch), the forward at the
  "select" shapes (Cin > 512, W > 256, W < 8), x and out in float32 or
  bfloat16, replaces ``_sel_fwd_kernel`` (via ``dcn_v2_pallas_select``).
- ``dcn_sel_bwd`` (``csrc/dcn_sel_bwd.cu``, the same two launches as
  ``dcn_bwd``), its backward, g in x's dtype (rounded to bf16 for the
  kernels), dx rounded once to x's dtype, dW in the weight's dtype,
  replaces ``_sel_bwd_kernel`` (via ``dcn_v2_pallas_bwd_select``).
- ``dcn_wide_fwd`` (``csrc/dcn_wide_fwd.cu``, one launch), the forward with
  dx clamped too (forced "lanes" at W > 256), replaces ``_dcn_kernel`` in
  panel mode (via ``_dcn_v2_pallas_wide``). Its backward is the exact op's
  on clipped offsets, as in the JAX package.

Each source notes what bounds it on the H100 and what its design does about
that. Their plain versions are ``ops.dcn.dcn_v2_twin`` and
``ops.dcn.dcn_v2_fused_twin`` (forward) and autograd through them
(backward): a wrapper takes them only for a tensor that lies on the CPU.
For a CUDA tensor it launches the kernel or raises.

The four forwards are custom ops of the namespace ``centernet_uda``
(``dcn_fwd``, ``dcn_fused_fwd``, ``dcn_sel_fwd``, ``dcn_wide_fwd``), each with
its kernel as the CUDA implementation, its plain twin as the CPU one and a
fake implementation that gives the output's shape and dtype, so that
``torch.export`` records the op in the graph of a model (``export.py``) and a
reloaded artifact launches the kernel. Importing this module registers them.
The ``autograd.Function`` of each route calls its op in ``forward``.

The sources are compiled at first use with ``nvcc`` (one process per source,
all started together) into ``build/kernels/`` at the root of the checkout,
under a name that carries a hash of the sources, and loaded with ``ctypes``.
Nothing is compiled or loaded at import.

``LAUNCHES`` counts, per kernel source, the launches made by the wrappers
(for a forward, inside the op's CUDA implementation, so an exported
artifact's calls count too); a run resets it with ``reset_launches()`` and
reads it to show which path ran. A CUDA graph's replay runs no wrapper:
``utils/graphs.py`` adds the launches a graph captured on every replay.

Every launch may be captured into a CUDA graph (the compiled steps,
``utils/graphs.py``): a wrapper allocates with ``torch.empty``/``torch.zeros``
and launches on ``torch.cuda.current_stream()``, and the launchers' host
calls (``cudaFuncGetAttributes``, ``cudaDeviceGetAttribute``,
``cudaFuncSetAttribute``, ``cudaGetLastError``) are legal under capture in
the global mode (``tests/test_torch_gpu.py`` captures each route so). A
library is loaded at a kernel's first, eager call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch

from centernet_uda_torch.ops.dcn import (
    PALLAS_MAX_SHIFT,
    dcn_v2,
    dcn_v2_fused_twin,
    dcn_v2_twin,
)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = {"dcn_fwd": "dcn_fwd.cu", "dcn_bwd": "dcn_bwd.cu",
           "dcn_fused_fwd": "dcn_fused_fwd.cu",
           "dcn_fused_bwd": "dcn_fused_bwd.cu",
           "dcn_sel_fwd": "dcn_sel_fwd.cu", "dcn_sel_bwd": "dcn_sel_bwd.cu",
           "dcn_wide_fwd": "dcn_wide_fwd.cu"}
_HEADERS = ("dcn_common.cuh", "dcn_mma.cuh", "dcn_fused.cuh",
            "dcn_sample_fwd.cuh", "dcn_sample_bwd.cuh")
# the explicit-offset forwards, each with a ``<name>_cin_per_block`` query
_EXPLICIT_FWD = ("dcn_fwd", "dcn_sel_fwd", "dcn_wide_fwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

_LIBS: Dict[str, ctypes.CDLL] = {}

# the backward's weight kernel splits the B*H*W reduction so that about
# this many blocks are in flight: its blocks cover all of Cout (up to 256),
# so about four per SM keep its atomics few
_DW_TARGET_BLOCKS = 528


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the DCN kernels")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (SOURCES[name],) + _HEADERS:
        digest.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_kernels() -> Dict[str, str]:
    """Compile every kernel source that has no library yet.

    One ``nvcc`` per source, all started together. Returns the compiler's
    output (the ``-Xptxas -v`` register and shared-memory report) per
    kernel that was built; raises with that output if a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in SOURCES.items():
        lib = _lib_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[name] = (lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failures = {}, []
    for name, (lib, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {SOURCES[name]}:\n{out}")
            continue
        os.replace(tmp, lib)
        reports[name] = out
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def _lib(name: str) -> ctypes.CDLL:
    if name in _LIBS:
        return _LIBS[name]
    path = _lib_path(name)
    if not path.exists():
        build_kernels()
    lib = ctypes.CDLL(str(path))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = getattr(lib, name)
    fn.argtypes = {
        "dcn_fwd": [vp] * 7 + [i32] * 6 + [f32, vp],
        "dcn_bwd": [vp] * 9 + [i32] * 5 + [f32, i32, vp],
        "dcn_fused_fwd": [vp] * 7 + [i32] * 5 + [f32, vp],
        "dcn_fused_bwd": [vp] * 11 + [i32] * 5 + [f32, i32, vp],
        "dcn_sel_fwd": [vp] * 7 + [i32] * 6 + [f32, i32, vp],
        "dcn_sel_bwd": [vp] * 9 + [i32] * 5 + [f32, i32, vp],
        "dcn_wide_fwd": [vp] * 7 + [i32] * 6 + [f32, i32, vp],
    }[name]
    fn.restype = i32
    if name in _EXPLICIT_FWD:
        query = getattr(lib, f"{name}_cin_per_block")
        query.argtypes = [i32] * 5
        query.restype = i32
    err_fn = getattr(lib, f"{name}_error_string")
    err_fn.argtypes = [i32]
    err_fn.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = getattr(_lib(name), f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


_F32 = (torch.float32,)
_F32_BF16 = (torch.float32, torch.bfloat16)


def _check(x, offset, mask, weight, bias=None, g=None, x_dtypes=_F32,
           weight_dtypes=_F32) -> Tuple[int, ...]:
    """Device, dtype and shape checks of the explicit-offset kernels: x (and
    g, in x's dtype) in ``x_dtypes``, the weight in ``weight_dtypes``,
    offset, mask and bias float32."""
    tensors = [x, offset, mask, weight] + [t for t in (bias, g)
                                           if t is not None]
    for t in tensors:
        if t.device != x.device:
            raise ValueError("DCN operands must lie on one device")
    for t, allowed in ((x, x_dtypes), (weight, weight_dtypes), (offset, _F32),
                       (mask, _F32), (bias, _F32), (g, (x.dtype,))):
        if t is not None and t.dtype not in allowed:
            names = " or ".join(str(d).replace("torch.", "")
                                for d in allowed)
            raise TypeError(f"the DCN kernels take {names} here, got "
                            f"{t.dtype}")
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, cin, 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} is not "
                         f"({cout}, {cin}, 3, 3)")
    if tuple(offset.shape) != (b, 18, h, w):
        raise ValueError(f"offset {tuple(offset.shape)} != {(b, 18, h, w)}")
    if tuple(mask.shape) != (b, 9, h, w):
        raise ValueError(f"mask {tuple(mask.shape)} != {(b, 9, h, w)}")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias {tuple(bias.shape)} != {(cout,)}")
    if g is not None and tuple(g.shape) != (b, cout, h, w):
        raise ValueError(f"gradient {tuple(g.shape)} != {(b, cout, h, w)}")
    if b * h * w * max(cin, cout, 18) >= 2 ** 31:
        raise ValueError("DCN operand too large for 32-bit pixel indices")
    return b, cin, h, w, cout


def _stage_x(x: torch.Tensor) -> torch.Tensor:
    """(B, Cin, H, W) -> channels-last bf16 copy, in one pass."""
    b, cin, h, w = x.shape
    xs = torch.empty((b, h, w, cin), dtype=torch.bfloat16, device=x.device)
    xs.copy_(x.permute(0, 2, 3, 1))
    return xs


def dcn_forward(x, offset, mask, weight, bias,
                max_shift: float = PALLAS_MAX_SHIFT) -> torch.Tensor:
    """DCNv2 forward, 3x3/s1/p1/d1. NCHW in and out; float32. The op
    ``centernet_uda::dcn_fwd``: ``dcn_fwd`` on a CUDA tensor, the plain twin
    on a CPU tensor."""
    return torch.ops.centernet_uda.dcn_fwd(x, offset, mask, weight, bias,
                                           float(max_shift))


@torch.library.custom_op("centernet_uda::dcn_fwd", mutates_args=(),
                         device_types="cuda")
def _dcn_fwd_op(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                weight: torch.Tensor, bias: torch.Tensor,
                max_shift: float) -> torch.Tensor:
    _check(x, offset, mask, weight, bias)
    with torch.cuda.device(x.device):
        return _explicit_forward_launch(
            "dcn_fwd", x, offset, mask, weight, bias, max_shift,
            torch.cuda.current_stream().cuda_stream)


@_dcn_fwd_op.register_kernel("cpu")
def _dcn_fwd_cpu(x, offset, mask, weight, bias, max_shift):
    # contiguous NCHW, as the kernel's output and the fake's
    return dcn_v2_twin(x, offset, mask, weight, bias, max_shift).contiguous()


@_dcn_fwd_op.register_fake
def _dcn_fwd_fake(x, offset, mask, weight, bias, max_shift):
    b, _, h, w, cout = _check(x, offset, mask, weight, bias)
    return x.new_empty((b, cout, h, w))


def dcn_backward_plain(x, offset, mask, weight, g,
                       max_shift: float = PALLAS_MAX_SHIFT):
    """Plain version of ``dcn_backward``: autograd through the twin."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (x, offset, mask, weight)]
        out = dcn_v2_twin(*leaves, None, max_shift)
        return torch.autograd.grad(out, leaves, g)


def _dw_to_oihw(dw: torch.Tensor, cout: int) -> torch.Tensor:
    """(9, Cin, Cout) tap-major gradient -> (Cout, Cin, 3, 3)."""
    return dw.reshape(3, 3, -1, cout).permute(3, 2, 0, 1).contiguous()


def dcn_backward(x, offset, mask, weight, g,
                 max_shift: float = PALLAS_MAX_SHIFT):
    """Gradients (dx, doffset, dmask, dweight) of ``dcn_forward``; the bias
    gradient, sum(g), is the caller's."""
    if not x.is_cuda:
        return dcn_backward_plain(x, offset, mask, weight, g, max_shift)
    g = g.float()
    _check(x, offset, mask, weight, None, g)
    with torch.cuda.device(x.device):
        return _explicit_backward_launch(
            "dcn_bwd", x, offset, mask, weight, g, max_shift,
            torch.cuda.current_stream().cuda_stream)


class _DCNKernelFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias):
        ctx.save_for_backward(x, offset, mask, weight)
        return dcn_forward(x, offset, mask, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, offset, mask, weight = ctx.saved_tensors
        dx, doff, dmask, dw = dcn_backward(x, offset, mask, weight, g)
        return dx, doff, dmask, dw, g.sum((0, 2, 3))


def dcn_v2_kernel(x, offset, mask, weight, bias) -> torch.Tensor:
    """The kernel path of ``DCN``: the Hopper kernels on CUDA tensors, the
    plain twin on CPU tensors, differentiable either way."""
    return _DCNKernelFn.apply(x, offset, mask, weight, bias)


def _check_fused(x, om_weight, om_bias, weight, bias=None, g=None
                 ) -> Tuple[int, ...]:
    params = [t for t in (om_weight, om_bias, weight, bias) if t is not None]
    for t in params + ([g] if g is not None else []):
        if t.device != x.device:
            raise ValueError("DCN operands must lie on one device")
    if x.dtype != torch.bfloat16 or (g is not None
                                     and g.dtype != torch.bfloat16):
        raise TypeError(f"the fused DCN kernels take bfloat16 x and g, got "
                        f"{x.dtype}")
    for t in params:
        if t.dtype != torch.float32:
            raise TypeError(f"the fused DCN kernels take float32 parameters, "
                            f"got {t.dtype}")
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, cin, 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} is not "
                         f"({cout}, {cin}, 3, 3)")
    if tuple(om_weight.shape) != (27, cin, 3, 3):
        raise ValueError(f"offset-conv weight {tuple(om_weight.shape)} is "
                         f"not (27, {cin}, 3, 3)")
    if tuple(om_bias.shape) != (27,):
        raise ValueError(f"offset-conv bias {tuple(om_bias.shape)} != (27,)")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias {tuple(bias.shape)} != {(cout,)}")
    if g is not None and tuple(g.shape) != (b, cout, h, w):
        raise ValueError(f"gradient {tuple(g.shape)} != {(b, cout, h, w)}")
    if b * h * w * max(cin, cout, 27) >= 2 ** 31:
        raise ValueError("DCN operand too large for 32-bit pixel indices")
    return b, cin, h, w, cout


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _stage_x_padded(x: torch.Tensor) -> torch.Tensor:
    """(B, Cin, H, W) -> channels-last bf16 (B, H, W, Cp), Cp = Cin rounded
    up to a multiple of 8 with zero channels, in one pass."""
    b, cin, h, w = x.shape
    cp = _pad8(cin)
    if cp == cin:
        return _stage_x(x)
    xs = torch.zeros((b, h, w, cp), dtype=torch.bfloat16, device=x.device)
    xs[..., :cin].copy_(x.permute(0, 2, 3, 1))
    return xs


def _stage_weight_padded(weight: torch.Tensor, cp: int,
                         width: int) -> torch.Tensor:
    """(N, Cin, 3, 3) -> (9, Cp, width) bf16, tap-major, Cin and N padded
    with zeros: the layout of the tensor-core kernels' weights."""
    n, cin = weight.shape[:2]
    out = torch.zeros((9, cp, width), dtype=torch.bfloat16,
                      device=weight.device)
    out[:, :cin, :n].copy_(weight.permute(2, 3, 1, 0).reshape(9, cin, n))
    return out


def _stage_fused_weights(om_weight, weight, cp: int):
    """The fused kernels' weights: the offset conv's (27, Cin, 3, 3) -> (9,
    Cp, 32), the layer's (Cout, Cin, 3, 3) -> (9, Cp, Cout rounded up to
    16)."""
    return (_stage_weight_padded(om_weight, cp, 32),
            _stage_weight_padded(weight, cp, -(-weight.shape[0] // 16) * 16))


def _stage_g(g: torch.Tensor) -> torch.Tensor:
    """The output gradient as the backward kernels read it: (B, Cout, H, W)
    bf16 (a float32 g rounded once, to nearest even), contiguous and
    16-byte aligned (the weight kernel copies its rows 16 bytes at a
    time)."""
    g = g.to(torch.bfloat16).contiguous()
    return g if g.data_ptr() % 16 == 0 else g.clone()


def _dw_pixels_per_block(n_pix: int, cp: int, cout: int) -> int:
    """Pixels per block of the backward weight kernel's split-K, a multiple
    of its 64-pixel step."""
    tiles = 9 * (-(-cp // 64)) * (-(-cout // 256))
    splits = max(1, -(-_DW_TARGET_BLOCKS // tiles))
    per = -(-n_pix // splits)
    return max(64, -(-per // 64) * 64)


def _explicit_backward_launch(name, x, offset, mask, weight, g, max_shift,
                              stream):
    """One call of ``dcn_bwd`` or ``dcn_sel_bwd`` (same operands, two
    launches): dx in x's dtype, doffset and dmask float32, dW in the
    weight's dtype."""
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    xs = _stage_x_padded(x)
    cp = xs.shape[-1]
    wt = _stage_weight_padded(weight, cp, -(-cout // 16) * 16)
    gs = _stage_g(g)
    offset, mask = offset.contiguous(), mask.contiguous()
    # all zeroed: where the data kernel splits Cin, doffset and dmask are
    # sums of atomics too
    dx = torch.zeros((b, h, w, cp), **f32)
    doff = torch.zeros_like(offset)
    dmask = torch.zeros_like(mask)
    dw = torch.zeros((9, cp, cout), **f32)
    err = getattr(_lib(name), name)(
        xs.data_ptr(), offset.data_ptr(), mask.data_ptr(), wt.data_ptr(),
        gs.data_ptr(), dx.data_ptr(), doff.data_ptr(), dmask.data_ptr(),
        dw.data_ptr(), b, h, w, cp, cout, float(max_shift),
        _dw_pixels_per_block(b * h * w, cp, cout), stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    # dx rounded to x's dtype once, after every reduction is in
    dx_out = torch.empty((b, cin, h, w), dtype=x.dtype, device=x.device)
    dx_out.copy_(dx[..., :cin].permute(0, 3, 1, 2))
    return (dx_out, doff, dmask,
            _dw_to_oihw(dw[:, :cin], cout).to(weight.dtype))


def dcn_fused_forward(x, om_weight, om_bias, weight, bias,
                      max_shift: float = PALLAS_MAX_SHIFT):
    """The bf16 DCNv2 layer with its offset conv, 3x3/s1/p1/d1: ``(out,
    max_abs_dy)``. x (B, Cin, H, W) bf16; the offset conv's (27, Cin, 3, 3)
    weight and (27,) bias, the layer's (Cout, Cin, 3, 3) weight and (Cout,)
    bias f32. out (B, Cout, H, W) bf16; max_abs_dy an f32 0-dim tensor. The
    op ``centernet_uda::dcn_fused_fwd``: ``dcn_fused_fwd`` on a CUDA tensor,
    the fused twin on a CPU tensor."""
    return torch.ops.centernet_uda.dcn_fused_fwd(
        x, om_weight, om_bias, weight, bias, float(max_shift))


@torch.library.custom_op("centernet_uda::dcn_fused_fwd", mutates_args=(),
                         device_types="cuda")
def _dcn_fused_fwd_op(x: torch.Tensor, om_weight: torch.Tensor,
                      om_bias: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, max_shift: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_fused(x, om_weight, om_bias, weight, bias)
    with torch.cuda.device(x.device):
        return _fused_forward_launch(x, om_weight, om_bias, weight, bias,
                                     max_shift,
                                     torch.cuda.current_stream().cuda_stream)


@_dcn_fused_fwd_op.register_kernel("cpu")
def _dcn_fused_fwd_cpu(x, om_weight, om_bias, weight, bias, max_shift):
    out, stat = dcn_v2_fused_twin(x, om_weight, om_bias, weight, bias,
                                  max_shift)
    return out.contiguous(), stat


@_dcn_fused_fwd_op.register_fake
def _dcn_fused_fwd_fake(x, om_weight, om_bias, weight, bias, max_shift):
    b, _, h, w, cout = _check_fused(x, om_weight, om_bias, weight, bias)
    return (x.new_empty((b, cout, h, w)),
            x.new_empty((), dtype=torch.float32))


def _fused_forward_launch(x, om_weight, om_bias, weight, bias, max_shift,
                          stream):
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    dev = x.device
    xs = _stage_x_padded(x)
    cp = xs.shape[-1]
    wom, wt = _stage_fused_weights(om_weight, weight, cp)
    om_bias, bias = om_bias.contiguous(), bias.contiguous()
    out = torch.empty((b, cout, h, w), dtype=torch.bfloat16, device=dev)
    stat = torch.zeros(1, dtype=torch.int32, device=dev)
    err = _lib("dcn_fused_fwd").dcn_fused_fwd(
        xs.data_ptr(), wom.data_ptr(), om_bias.data_ptr(), wt.data_ptr(),
        bias.data_ptr(), out.data_ptr(), stat.data_ptr(), b, h, w, cp, cout,
        float(max_shift), stream)
    _raise_on(err, "dcn_fused_fwd")
    LAUNCHES["dcn_fused_fwd"] += 1
    return out, stat.view(torch.float32).reshape(())


def dcn_fused_backward_plain(x, om_weight, om_bias, weight, g,
                             max_shift: float = PALLAS_MAX_SHIFT):
    """Plain version of ``dcn_fused_backward``: autograd through the
    fused twin."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (x, om_weight, om_bias, weight)]
        out, _ = dcn_v2_fused_twin(*leaves, None, max_shift)
        return torch.autograd.grad(out, leaves, g)


def dcn_fused_backward(x, om_weight, om_bias, weight, g,
                       max_shift: float = PALLAS_MAX_SHIFT):
    """Gradients ``(dx, d om_weight, d om_bias, dweight)`` of
    ``dcn_fused_forward`` for the bf16 output gradient g; dx is bf16, the
    rest f32. The bias gradient, sum(g), is the caller's."""
    if not x.is_cuda:
        return dcn_fused_backward_plain(x, om_weight, om_bias, weight, g,
                                        max_shift)
    _check_fused(x, om_weight, om_bias, weight, None, g)
    with torch.cuda.device(x.device):
        return _fused_backward_launch(
            x, om_weight, om_bias, weight, g, max_shift,
            torch.cuda.current_stream().cuda_stream)


def _fused_backward_launch(x, om_weight, om_bias, weight, g, max_shift,
                           stream):
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    xs = _stage_x_padded(x)
    cp = xs.shape[-1]
    wom, wt = _stage_fused_weights(om_weight, weight, cp)
    g = _stage_g(g)
    om_bias = om_bias.contiguous()
    om = torch.empty((b, 27, h, w), **f32)
    dz = torch.zeros((b, 27, h, w), **f32)
    dx = torch.zeros((b, h, w, cp), **f32)
    dw = torch.zeros((9, cp, cout), **f32)
    dwom = torch.zeros((9, cp, 27), **f32)
    dbom = torch.zeros(27, **f32)
    err = _lib("dcn_fused_bwd").dcn_fused_bwd(
        xs.data_ptr(), wom.data_ptr(), om_bias.data_ptr(), wt.data_ptr(),
        g.data_ptr(), om.data_ptr(), dz.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), dwom.data_ptr(), dbom.data_ptr(), b, h, w, cp, cout,
        float(max_shift), _dw_pixels_per_block(b * h * w, cp, cout), stream)
    _raise_on(err, "dcn_fused_bwd")
    LAUNCHES["dcn_fused_bwd"] += 1
    # dx rounded to bf16 once, after both of its parts are in
    dx_out = torch.empty((b, cin, h, w), dtype=torch.bfloat16, device=dev)
    dx_out.copy_(dx[..., :cin].permute(0, 3, 1, 2))
    return (dx_out, _dw_to_oihw(dwom[:, :cin], 27), dbom,
            _dw_to_oihw(dw[:, :cin], cout))


class _DCNFusedFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, om_weight, om_bias, weight, bias):
        ctx.save_for_backward(x, om_weight, om_bias, weight)
        out, stat = dcn_fused_forward(x, om_weight, om_bias, weight, bias)
        ctx.mark_non_differentiable(stat)
        return out, stat

    @staticmethod
    def backward(ctx, g, _g_stat):
        x, om_weight, om_bias, weight = ctx.saved_tensors
        grads = dcn_fused_backward(x, om_weight, om_bias, weight,
                                   g.to(torch.bfloat16))
        return (*grads, g.float().sum((0, 2, 3)))


def dcn_v2_fused_kernel(x, om_weight, om_bias, weight, bias):
    """The bf16 kernel path of ``DCN``: ``(out, max_abs_dy)`` from the fused
    Hopper kernels on CUDA tensors, from the fused twin on CPU tensors,
    differentiable either way (max_abs_dy has no gradient)."""
    return _DCNFusedFn.apply(x, om_weight, om_bias, weight, bias)


def dcn_sel_forward(x, offset, mask, weight, bias,
                    max_shift: float = PALLAS_MAX_SHIFT) -> torch.Tensor:
    """DCNv2 forward at the "select" shapes, 3x3/s1/p1/d1. x (B, Cin, H, W)
    float32 or bfloat16, offset and mask float32, the weight float32 or
    bfloat16, bias float32; out (B, Cout, H, W) in x's dtype. The op
    ``centernet_uda::dcn_sel_fwd``: ``dcn_sel_fwd`` on a CUDA tensor, the
    plain twin on a CPU tensor."""
    return torch.ops.centernet_uda.dcn_sel_fwd(x, offset, mask, weight, bias,
                                               float(max_shift))


@torch.library.custom_op("centernet_uda::dcn_sel_fwd", mutates_args=(),
                         device_types="cuda")
def _dcn_sel_fwd_op(x: torch.Tensor, offset: torch.Tensor,
                    mask: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, max_shift: float) -> torch.Tensor:
    _check(x, offset, mask, weight, bias, x_dtypes=_F32_BF16,
           weight_dtypes=_F32_BF16)
    with torch.cuda.device(x.device):
        return _explicit_forward_launch(
            "dcn_sel_fwd", x, offset, mask, weight, bias, max_shift,
            torch.cuda.current_stream().cuda_stream)


@_dcn_sel_fwd_op.register_kernel("cpu")
def _dcn_sel_fwd_cpu(x, offset, mask, weight, bias, max_shift):
    return dcn_v2_twin(x, offset, mask, weight, bias, max_shift).contiguous()


@_dcn_sel_fwd_op.register_fake
def _dcn_sel_fwd_fake(x, offset, mask, weight, bias, max_shift):
    b, _, h, w, cout = _check(x, offset, mask, weight, bias,
                              x_dtypes=_F32_BF16, weight_dtypes=_F32_BF16)
    return x.new_empty((b, cout, h, w))


def _explicit_forward_launch(name, x, offset, mask, weight, bias,
                             max_shift, stream):
    """One launch of ``dcn_fwd``, ``dcn_sel_fwd`` or ``dcn_wide_fwd`` (the
    last two with x and out in float32 or bfloat16), on ``stream``, for
    checked operands. Each wrapper has such a kernel path proper
    (``_fused_forward_launch``, ``_fused_backward_launch`` and
    ``_explicit_backward_launch`` for the float32 and select backwards);
    ``tests/test_torch_emulated_kernels.py`` calls them on CPU tensors with
    the sources built for the CPU.

    Where the grid is short, the kernel splits Cin across blocks (the
    library's ``<name>_cin_per_block`` says so): the slices then add into a
    zeroed f32 buffer, ``out`` itself for a float32 output, else rounded
    to bf16 once here."""
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    xs = _stage_x_padded(x)
    cp = xs.shape[-1]
    wt = _stage_weight_padded(weight, cp, -(-cout // 16) * 16)
    offset, mask, bias = (offset.contiguous(), mask.contiguous(),
                          bias.contiguous())
    lib = _lib(name)
    per_block = getattr(lib, f"{name}_cin_per_block")(b, h, w, cp, cout)
    _raise_on(max(-per_block, 0), name)
    f32 = x.dtype == torch.float32
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device)
    sums = None
    if per_block < cp:
        sums = (out.zero_() if f32 else
                torch.zeros((b, cout, h, w), dtype=torch.float32,
                            device=x.device))
    flag = [] if name == "dcn_fwd" else [int(not f32)]
    err = getattr(lib, name)(
        xs.data_ptr(), offset.data_ptr(), mask.data_ptr(), wt.data_ptr(),
        bias.data_ptr(), out.data_ptr(),
        None if sums is None else sums.data_ptr(), b, h, w, cp, cout,
        per_block, float(max_shift), *flag, stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1
    if sums is not None and not f32:
        out.copy_(sums)
    return out


def dcn_sel_backward(x, offset, mask, weight, g,
                     max_shift: float = PALLAS_MAX_SHIFT):
    """Gradients (dx, doffset, dmask, dweight) of ``dcn_sel_forward`` for g
    in x's dtype: dx in x's dtype, doffset and dmask float32, dweight in the
    weight's dtype. The bias gradient, sum(g), is the caller's."""
    if not x.is_cuda:
        return dcn_backward_plain(x, offset, mask, weight, g, max_shift)
    _check(x, offset, mask, weight, None, g, x_dtypes=_F32_BF16,
           weight_dtypes=_F32_BF16)
    with torch.cuda.device(x.device):
        return _explicit_backward_launch(
            "dcn_sel_bwd", x, offset, mask, weight, g, max_shift,
            torch.cuda.current_stream().cuda_stream)


class _DCNSelectFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias):
        ctx.save_for_backward(x, offset, mask, weight)
        return dcn_sel_forward(x, offset, mask, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, offset, mask, weight = ctx.saved_tensors
        dx, doff, dmask, dw = dcn_sel_backward(x, offset, mask, weight,
                                               g.to(x.dtype))
        return dx, doff, dmask, dw, g.float().sum((0, 2, 3))


def dcn_v2_select_kernel(x, offset, mask, weight, bias) -> torch.Tensor:
    """The "select" route of ``DCN``: rows 6 and 7's Hopper kernels on CUDA
    tensors, the plain twin on CPU tensors, differentiable either way; out
    in x's dtype, the weight's gradient in its dtype."""
    return _DCNSelectFn.apply(x, offset, mask, weight, bias)


def dcn_wide_forward(x, offset, mask, weight, bias,
                     max_shift: float = PALLAS_MAX_SHIFT) -> torch.Tensor:
    """DCNv2 forward with both offsets clamped to +-max_shift (forced
    "lanes" at W > 256), 3x3/s1/p1/d1; operands as ``dcn_sel_forward``'s.
    The op ``centernet_uda::dcn_wide_fwd``: ``dcn_wide_fwd`` on a CUDA
    tensor, the clamp-dx twin on a CPU tensor."""
    return torch.ops.centernet_uda.dcn_wide_fwd(x, offset, mask, weight,
                                                bias, float(max_shift))


@torch.library.custom_op("centernet_uda::dcn_wide_fwd", mutates_args=(),
                         device_types="cuda")
def _dcn_wide_fwd_op(x: torch.Tensor, offset: torch.Tensor,
                     mask: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, max_shift: float) -> torch.Tensor:
    _check(x, offset, mask, weight, bias, x_dtypes=_F32_BF16,
           weight_dtypes=_F32_BF16)
    with torch.cuda.device(x.device):
        return _explicit_forward_launch(
            "dcn_wide_fwd", x, offset, mask, weight, bias, max_shift,
            torch.cuda.current_stream().cuda_stream)


@_dcn_wide_fwd_op.register_kernel("cpu")
def _dcn_wide_fwd_cpu(x, offset, mask, weight, bias, max_shift):
    return dcn_v2_twin(x, offset, mask, weight, bias, max_shift,
                       clamp_dx=True).contiguous()


@_dcn_wide_fwd_op.register_fake
def _dcn_wide_fwd_fake(x, offset, mask, weight, bias, max_shift):
    b, _, h, w, cout = _check(x, offset, mask, weight, bias,
                              x_dtypes=_F32_BF16, weight_dtypes=_F32_BF16)
    return x.new_empty((b, cout, h, w))


def dcn_wide_backward(x, offset, mask, weight, bias, g,
                      max_shift: float = PALLAS_MAX_SHIFT):
    """Gradients (dx, doffset, dmask, dweight, dbias) of the wide route:
    autograd through the exact ``dcn_v2`` on offsets clipped to
    +-max_shift, its output cast to x's dtype (the JAX package's
    ``_dcn_pallas_bwd`` for forced "lanes" at W > 256)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (x, offset, mask, weight, bias)]
        out = dcn_v2(leaves[0], leaves[1].clamp(-max_shift, max_shift),
                     *leaves[2:]).to(x.dtype)
        return torch.autograd.grad(out, leaves, g)


class _DCNWideFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias):
        ctx.save_for_backward(x, offset, mask, weight, bias)
        return dcn_wide_forward(x, offset, mask, weight, bias)

    @staticmethod
    def backward(ctx, g):
        return dcn_wide_backward(*ctx.saved_tensors, g)


def dcn_v2_wide_kernel(x, offset, mask, weight, bias) -> torch.Tensor:
    """The wide route of ``DCN`` (forced "lanes", 256 < W <= 1024): row 2's
    Hopper forward on CUDA tensors, the clamp-dx twin on CPU tensors; the
    exact op's backward on clipped offsets either way."""
    return _DCNWideFn.apply(x, offset, mask, weight, bias)


def compiler_report(reports: Dict[str, str]) -> str:
    """The ``ptxas`` register / shared-memory lines of ``build_kernels()``'s
    report."""
    lines = []
    for name, out in reports.items():
        lines += [f"{name}: {ln.strip()}" for ln in out.splitlines()
                  if ("ptxas" in ln and ("registers" in ln or "smem" in ln
                                         or "Compiling" in ln))
                  or "spill" in ln]
    return "\n".join(lines)
