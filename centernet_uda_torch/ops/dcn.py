"""DCNv2 modulated deformable convolution in PyTorch (NCHW).

Four functions:

- ``dcn_v2``: the exact, unbounded sampler (the semantics of the reference
  CUDA extension's ``modulated_deformable_im2col``): bilinear samples with
  zero reads outside the map, times the mask, contracted with the weight.
  Any kernel size, stride, padding and dilation. Gradients by autograd.
- ``dcn_v2_twin``: the plain version of the Hopper kernels
  (``ops/dcn_cuda.py``), with their semantics: 3x3 / stride 1 / pad 1 /
  dilation 1, the vertical offset clamped to +-``PALLAS_MAX_SHIFT`` with a
  zero gradient where ``|dy| >= PALLAS_MAX_SHIFT``, horizontal sampling
  exact (clamped the same way with ``clamp_dx``, the wide forward's
  semantics), x and the weight staged in bf16, the samples rounded to bf16,
  f32 accumulation, the output in x's dtype.
- ``dcn_v2_fused_twin``: the plain version of the fused bfloat16 Hopper
  kernels, the whole layer from x: the 3x3 offset conv (bf16 x and
  bf16-rounded weights, f32 accumulation plus the f32 bias; om stays f32),
  ``dcn_v2_twin`` on its offsets and sigmoid mask, the output rounded to
  bf16 once; also max |dy|, the clamp monitor.
- ``DCN``: the module (reference ``libs/DCNv2/dcn_v2.py`` class ``DCN``):
  a zero-initialised ``conv_offset_mask`` conv gives ``(o1, o2, mask
  logits)``; ``offset = cat(o1, o2)`` and the mask is their sigmoid.

Operands: x (B, Cin, H, W); offset (B, 2K, Ho, Wo) with channel 2t = dy and
2t+1 = dx of tap t in row-major tap order; mask (B, K, Ho, Wo) post-sigmoid;
weight (Cout, Cin, kh, kw). The offset conv's 27 output channels are read
the same way: tap t takes dy from channel 2t, dx from 2t+1 and its mask
logit from 18+t.

``dcn_impl`` selects the implementation of each ``DCN`` module:
``auto`` runs the Hopper kernels on CUDA tensors and the exact op on CPU
tensors; ``cuda`` runs the kernel path (for a CPU tensor that is the plain
twin); ``xla`` runs the exact op; ``pallas`` is read as ``cuda`` so the
shared configs run unchanged.

Routing on the kernel path, as the JAX package routes its Pallas path
(``centernet_uda_tpu/ops/dcn.py`` and ``dcn_pallas.generation_for``).
Which kernels run decides which function is computed (the clamped kernel
semantics, the wide forward's clamped dx, or the exact op), so the
envelopes are copied as they are, VMEM estimates included:

- ``generation_for``: "lanes" for 8 <= W <= 256 and Cin <= 512, "select"
  elsewhere, unless ``set_kernel_version`` (or ``CENTERNET_DCN_KERNEL``,
  read at import) forces one;
- ``pallas_supported``: 3x3 / s1 / p1 / d1 within the generation's working
  set; where it is False the exact op runs;
- ``fused_supported``: bf16 x on the lanes generation at 8 <= W <= 256:
  the fused kernels, offset conv inside (``dcn_v2_fused_kernel``);
- otherwise the offset conv runs explicitly at the module dtype (in bf16
  the bias is added after the conv's rounding, and offsets and mask go on
  in f32), then the "select" kernels (``dcn_v2_select_kernel``, x and out
  in f32 or bf16), the lanes kernels at W <= 256 (``dcn_v2_kernel``, f32)
  or, with forced "lanes" at 256 < W <= 1024, the wide forward with dx
  clamped too and the exact op's backward (``dcn_v2_wide_kernel``).

``kernel_route`` names the route of one call.

Compute dtype (``DCN(dtype=...)``, the JAX package's ``precision``): the
parameters stay float32. The exact path in bfloat16 runs the JAX package's
explicit composition (bf16 offset conv, f32 offsets and mask, the exact
sampler on bf16 x with an f32 contraction, f32 out); the kernel routes give
x's dtype out.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

log = logging.getLogger(__name__)

PALLAS_MAX_SHIFT = 14

DCN_IMPLS = ("auto", "cuda", "xla", "pallas")

# kernel generation: "auto" routes each map shape as the JAX package does;
# "lanes" / "select" force one (centernet_uda_tpu/ops/dcn_pallas.py)
KERNEL_VERSIONS = ("auto", "lanes", "select")
_KERNEL_VERSION = os.environ.get("CENTERNET_DCN_KERNEL", "auto")
# the widest map the lanes kernels take without clamping dx
LANES_NATIVE_MAX_W = 256
_VMEM_BYTES = 80 * 1024 * 1024


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def deform_sample(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  kernel, stride, padding, dilation) -> torch.Tensor:
    """Gather + bilinear sample + mask -> (B, Cin, K, Ho, Wo) columns."""
    kh, kw = kernel
    sh, sw = stride
    ph, pw = padding
    dh, dw = dilation
    k = kh * kw
    b, cin, h, w = x.shape
    ho, wo = mask.shape[-2:]
    dev = x.device
    # sampling positions are float32 whatever x's dtype
    oy = (torch.arange(ho, device=dev) * sh - ph).float()
    ox = (torch.arange(wo, device=dev) * sw - pw).float()
    ty = (torch.arange(kh, device=dev) * dh).repeat_interleave(kw).float()
    tx = (torch.arange(kw, device=dev) * dw).repeat(kh).float()
    off = offset.float().reshape(b, k, 2, ho, wo)
    py = oy.view(1, 1, ho, 1) + ty.view(1, k, 1, 1) + off[:, :, 0]
    px = ox.view(1, 1, 1, wo) + tx.view(1, k, 1, 1) + off[:, :, 1]

    y0 = torch.floor(py)
    x0 = torch.floor(px)
    wy1 = py - y0  # weight of the y0+1 row
    wx1 = px - x0
    x_flat = x.reshape(b, cin, h * w)

    def corner(yi, xi, wgt):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        got = torch.gather(x_flat, 2, idx.reshape(b, 1, -1).expand(b, cin, -1))
        wgt = torch.where(valid, wgt, torch.zeros_like(wgt))
        return got.reshape(b, cin, k, ho, wo) * wgt.unsqueeze(1).to(x.dtype)

    val = (corner(y0, x0, (1 - wy1) * (1 - wx1))
           + corner(y0, x0 + 1, (1 - wy1) * wx1)
           + corner(y0 + 1, x0, wy1 * (1 - wx1))
           + corner(y0 + 1, x0 + 1, wy1 * wx1))
    return val * mask.reshape(b, 1, k, ho, wo).to(val.dtype)


def _contract(cols: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor]) -> torch.Tensor:
    b, cin, k, ho, wo = cols.shape
    cout = weight.shape[0]
    # f32 accumulation and an f32 result whatever the operands' dtype
    out = torch.einsum("bckp,ock->bop",
                       cols.reshape(b, cin, k, ho * wo).float(),
                       weight.reshape(cout, cin, k).float())
    if bias is not None:
        out = out + bias.view(1, -1, 1)
    return out.reshape(b, cout, ho, wo)


def dcn_v2(x, offset, mask, weight, bias=None, stride=1, padding=1,
           dilation=1) -> torch.Tensor:
    """The exact modulated deformable convolution (deformable_groups=1)."""
    cout, cin, kh, kw = weight.shape
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    b, _, h, w = x.shape
    ho = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    wo = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    if offset.shape != (b, 2 * kh * kw, ho, wo):
        raise ValueError(f"offset {tuple(offset.shape)} != "
                         f"{(b, 2 * kh * kw, ho, wo)}")
    if mask.shape != (b, kh * kw, ho, wo):
        raise ValueError(f"mask {tuple(mask.shape)} != {(b, kh * kw, ho, wo)}")
    cols = deform_sample(x, offset, mask, (kh, kw), (sh, sw), (ph, pw),
                         (dh, dw))
    return _contract(cols, weight, bias)


def _bf16_value(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 in value, with an identity gradient."""
    return t + (t.to(torch.bfloat16).to(t.dtype) - t).detach()


def _clamped(v: torch.Tensor, max_shift: float) -> torch.Tensor:
    """v clamped to +-max_shift, with a zero gradient where |v| >=
    max_shift."""
    return torch.where(v.abs() < max_shift, v,
                       v.clamp(-max_shift, max_shift).detach())


def dcn_v2_twin(x, offset, mask, weight, bias=None,
                max_shift: float = PALLAS_MAX_SHIFT,
                clamp_dx: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the Hopper DCN kernels (3x3/s1/p1/d1).

    x and the output in float32 or bfloat16 (the sampling and the
    contraction run in f32 either way); the weight in either too.
    Autograd through it gives the kernels' backward: the dy gradient is
    zero where ``|dy| >= max_shift`` (the clamp saturates), both y-corners
    enter the offset gradient at integer positions (the derivative of
    ``floor`` is zero), and the rounding of the samples to bf16 rounds the
    column gradient ``g . W^T`` to bf16 as the kernels do; dx and dW come
    out in x's and the weight's dtypes, each rounded once. ``clamp_dx``
    clamps the horizontal offset the same way (the wide forward).
    """
    b, _, h, w = x.shape
    if tuple(weight.shape[2:]) != (3, 3):
        raise ValueError("the DCN kernels are 3x3 only")
    off = offset.reshape(b, 9, 2, h, w)
    dx = off[:, :, 1]
    if clamp_dx:
        dx = _clamped(dx, max_shift)
    offset_c = torch.stack((_clamped(off[:, :, 0], max_shift), dx),
                           2).reshape(offset.shape)
    cols = deform_sample(_bf16_value(x.float()), offset_c, mask, (3, 3),
                         (1, 1), (1, 1), (1, 1))
    cols = cols.to(torch.bfloat16).float()
    return _contract(cols, _bf16_value(weight.float()), bias).to(x.dtype)


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the gradient rounded to bf16 in value."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def dcn_v2_fused_twin(x, om_weight, om_bias, weight, bias=None,
                      max_shift: float = PALLAS_MAX_SHIFT):
    """Plain PyTorch version of the fused bf16 Hopper kernels (3x3 / s1 /
    p1 / d1): ``(out in bf16, max |dy| as an f32 0-dim tensor)``.

    x (B, Cin, H, W) bf16; om_weight (27, Cin, 3, 3), om_bias (27,),
    weight (Cout, Cin, 3, 3) and bias (Cout,) f32. Autograd through it
    gives the fused backward, with the rounding points of the TPU kernels
    it mirrors: x, the offset-conv weights, W and the samples in bf16 (so
    the column gradient g . W^T is rounded to bf16, as in ``dcn_v2_twin``);
    the gradient dz of om rounded to bf16 before the offset conv's weight
    and input gradients, unrounded in its bias gradient; dx rounded to bf16
    once, after both of its parts are summed in f32. The TPU kernels also
    round their horizontal tent weights to bf16; this twin keeps them f32,
    and the comparison tolerances cover the difference.
    """
    if tuple(om_weight.shape[2:]) != (3, 3) or tuple(weight.shape[2:]) != (
            3, 3):
        raise ValueError("the fused DCN kernels are 3x3 only")
    xf = x.float()
    om = _RoundGrad.apply(F.conv2d(xf, _bf16_value(om_weight.float()),
                                   None, padding=1))
    om = om + om_bias.float().view(1, -1, 1, 1)
    offset, mask = om[:, :18], torch.sigmoid(om[:, 18:])
    stat = offset[:, 0::2].detach().abs().amax()
    out = dcn_v2_twin(xf, offset, mask, weight.float(),
                      None if bias is None else bias.float(), max_shift)
    return out.to(torch.bfloat16), stat


def set_kernel_version(version: str) -> None:
    """Force a kernel generation ("lanes" / "select") or route per shape
    ("auto")."""
    global _KERNEL_VERSION
    if version not in KERNEL_VERSIONS:
        raise ValueError(f"kernel version must be one of {KERNEL_VERSIONS}, "
                         f"got {version!r}")
    _KERNEL_VERSION = version


def get_kernel_version() -> str:
    return _KERNEL_VERSION


def generation_for(x_shape) -> str:
    """The kernel generation of a (B, Cin, H, W) map: under "auto", "lanes"
    for 8 <= W <= 256 and Cin <= 512, "select" elsewhere."""
    if _KERNEL_VERSION != "auto":
        return _KERNEL_VERSION
    cin, w = x_shape[1], x_shape[3]
    if 8 <= w <= LANES_NATIVE_MAX_W and cin <= 512:
        return "lanes"
    return "select"


def _geometry_ok(kernel_size, stride, padding, dilation) -> bool:
    """The geometry the kernels cover: 3x3 / s1 / p1 / d1 (every DCN of the
    reference)."""
    return (_pair(kernel_size) == (3, 3) and _pair(stride) == (1, 1)
            and _pair(padding) == (1, 1) and _pair(dilation) == (1, 1))


def pallas_supported(x_shape, weight_shape, stride=1, padding=1,
                     dilation=1) -> bool:
    """Whether the kernel generation of this (B, Cin, H, W) map covers a
    layer of this (Cout, Cin, kh, kw) weight; else the exact op runs. The
    JAX package's envelope: 3x3 / s1 / p1 / d1, and its VMEM working-set
    estimate (the H-padded image in bf16, f32 and bf16, plus the dW
    accumulator, within 80 MiB); "lanes" also 8 <= W <= 1024, Cin <= 512."""
    if not _geometry_ok(weight_shape[2:], stride, padding, dilation):
        return False
    cin, h, w = x_shape[1], x_shape[2], x_shape[3]
    dw_resident = 3 * 9 * cin * weight_shape[0] * 4
    pad = 2 * (PALLAS_MAX_SHIFT + 2)
    if generation_for(x_shape) == "select":
        return (h + pad) * w * cin * 8 + dw_resident <= _VMEM_BYTES
    resident = (h + pad) * max(w, 128) * cin * 8
    return (8 <= w <= 1024 and cin <= 512
            and resident + dw_resident <= _VMEM_BYTES)


def fused_supported(x_shape, dtype, kernel_size=3, stride=1, padding=1,
                    dilation=1) -> bool:
    """The fused-offset-conv kernels: bf16 x, 3x3 / s1 / p1 / d1, the lanes
    generation at its native width 8 <= W <= 256."""
    return (dtype == torch.bfloat16
            and _geometry_ok(kernel_size, stride, padding, dilation)
            and generation_for(x_shape) == "lanes"
            and 8 <= x_shape[3] <= LANES_NATIVE_MAX_W)


def kernel_route(x_shape, dtype, weight_shape, stride=1, padding=1,
                 dilation=1) -> Optional[str]:
    """The kernel-path route of one call: "fused", "select", "lanes",
    "wide", or None for the exact op."""
    if not pallas_supported(x_shape, weight_shape, stride, padding,
                            dilation):
        return None
    if fused_supported(x_shape, dtype, weight_shape[2:], stride, padding,
                       dilation):
        return "fused"
    if generation_for(x_shape) == "select":
        return "select"
    return "wide" if x_shape[3] > LANES_NATIVE_MAX_W else "lanes"


# (shape, reason) of each exact-op fallback already logged
_FALLBACKS_NOTED: set = set()


def note_fallback(x_shape, route: Optional[str]) -> None:
    """Log once per shape where the kernel path leaves the kernels: the
    exact op outside the envelope, or the wide route's exact backward."""
    if route is None:
        reason = ("outside the kernel envelope of the " +
                  generation_for(x_shape) + " generation; the exact op runs")
    elif route == "wide":
        reason = (f"W > {LANES_NATIVE_MAX_W} under forced 'lanes': the "
                  "forward clamps dx too, the backward is the exact op's")
    else:
        return
    key = (tuple(x_shape), reason)
    if key not in _FALLBACKS_NOTED:
        _FALLBACKS_NOTED.add(key)
        log.warning("DCN layer with input %s: %s", tuple(x_shape), reason)


def uses_kernel_path(impl: str, x: torch.Tensor, weight: torch.Tensor,
                     stride=1, padding=1, dilation=1) -> bool:
    """Whether ``dcn_impl`` routes this call to the kernel path."""
    impl = impl.lower()
    if impl not in DCN_IMPLS:
        raise ValueError(f"dcn_impl must be one of {DCN_IMPLS}, got {impl!r}")
    if impl == "xla" or not _geometry_ok(tuple(weight.shape[2:]), stride,
                                         padding, dilation):
        return False
    if impl == "auto":
        return x.is_cuda
    return True


class DCN(nn.Module):
    """Deformable conv with a learned offset + mask head (NCHW).

    Parameter names reproduce the reference state dict: ``weight``,
    ``bias``, ``conv_offset_mask.weight``, ``conv_offset_mask.bias``.
    ``max_abs_dy`` holds, after a forward on the kernel path, max |dy| over
    the even offset channels (a 0-dim tensor, no gradient), else None; the
    trainer reads it to catch saturation of the clamp; ``torch.export``
    leaves it out of a serving graph. ``dtype`` is the
    compute dtype (float32 or bfloat16); the parameters stay float32.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3,
                 stride=1, padding=1, dilation=1, impl: str = "auto",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.impl = impl
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kh, kw))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.conv_offset_mask = nn.Conv2d(
            in_channels, 3 * kh * kw, (kh, kw), stride=stride,
            padding=padding, dilation=dilation, bias=True)
        self.max_abs_dy: Optional[torch.Tensor] = None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        cin, kh, kw = self.weight.shape[1:]
        stdv = 1.0 / math.sqrt(cin * kh * kw)
        # drawn on the CPU, so a seed gives the same weights on every device
        values = torch.empty(self.weight.shape).uniform_(-stdv, stdv,
                                                         generator=generator)
        with torch.no_grad():
            self.weight.copy_(values)
            self.bias.zero_()
            self.conv_offset_mask.weight.zero_()
            self.conv_offset_mask.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        route = None
        if uses_kernel_path(self.impl, x, self.weight, self.stride,
                            self.padding, self.dilation):
            route = kernel_route(tuple(x.shape), x.dtype,
                                 tuple(self.weight.shape), self.stride,
                                 self.padding, self.dilation)
            note_fallback(tuple(x.shape), route)
        if route == "fused":
            from centernet_uda_torch.ops.dcn_cuda import dcn_v2_fused_kernel

            om_conv = self.conv_offset_mask
            out, max_abs_dy = dcn_v2_fused_kernel(
                x, om_conv.weight, om_conv.bias, self.weight, self.bias)
            if not torch.compiler.is_exporting():
                self.max_abs_dy = max_abs_dy
            return out
        offset, mask = self._offset_mask(x)
        weight = self.weight.to(x.dtype)
        if route is None:
            return self._exact(x, offset, mask, weight)
        from centernet_uda_torch.ops import dcn_cuda

        if not torch.compiler.is_exporting():
            self.max_abs_dy = offset[:, 0::2].detach().abs().amax()
        kernel = {"select": dcn_cuda.dcn_v2_select_kernel,
                  "lanes": dcn_cuda.dcn_v2_kernel,
                  "wide": dcn_cuda.dcn_v2_wide_kernel}[route]
        return kernel(x, offset, mask, weight, self.bias)

    def _offset_mask(self, x: torch.Tensor):
        """The explicit offset conv at the compute dtype: f32 offsets and
        mask. In bf16 (the JAX package's explicit composition) the conv
        rounds to bf16 and its bias is added after, in bf16."""
        om_conv = self.conv_offset_mask
        if x.dtype == torch.bfloat16:
            om = F.conv2d(x, om_conv.weight.to(x.dtype), None, self.stride,
                          self.padding, self.dilation)
            om = om + om_conv.bias.to(x.dtype).view(1, -1, 1, 1)
        else:
            om = om_conv(x)
        o1, o2, m = torch.chunk(om, 3, dim=1)
        return torch.cat((o1, o2), dim=1).float(), torch.sigmoid(m).float()

    def _exact(self, x, offset, mask, weight) -> torch.Tensor:
        self.max_abs_dy = None
        args = (x, offset, mask, weight, self.bias, self.stride,
                self.padding, self.dilation)
        if torch.is_grad_enabled():
            # recompute the column tensor in the backward instead of keeping
            # it (the reference extension likewise recomputes im2col)
            return checkpoint(dcn_v2, *args, use_reentrant=False)
        return dcn_v2(*args)
