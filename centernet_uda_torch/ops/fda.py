"""Fourier Domain Adaptation (FDA): the low-frequency amplitude swap.

Counterpart of ``centernet_uda_tpu/ops/fda.py`` (the reference's
``utils/image.py``: ``extract_ampl_phase`` :129-134, ``low_freq_mutate``
:137-157, ``FDA_source_to_target`` :189-230) in NCHW: ``torch.fft.fft2``
over the spatial dims in float32, on the images' device.
"""

from __future__ import annotations

import math

import torch


def _swap_mask(h: int, w: int, beta: float, use_circular: bool,
               device=None) -> torch.Tensor:
    """Boolean (H, W) mask of the spectrum cells that take the TARGET
    amplitude (unshifted FFT layout), with the reference torch path's
    quirks:

    - rectangular: the four corner blocks, rows in ``[0:b] | [h-b:h]`` and
      cols in ``[0:b] | [w-b:w]``, ``b = floor(min(h, w) * beta)``;
    - circular: the SOURCE amplitude is kept only inside the quarter-ellipse
      at the unshifted origin, whose FIRST semi-axis ``int(h * beta)`` runs
      along x (columns) and second ``int(w * beta)`` along y; everything
      else takes the target amplitude.
    """
    iy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    ix = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    if use_circular:
        ax_x = max(int(h * beta), 1)
        ax_y = max(int(w * beta), 1)
        return (ix / ax_x) ** 2 + (iy / ax_y) ** 2 > 1.0
    b = int(math.floor(min(h, w) * beta))
    return ((iy < b) | (iy >= h - b)) & ((ix < b) | (ix >= w - b))


def fda_source_to_target(src: torch.Tensor, trg: torch.Tensor,
                         beta: float = 0.1, use_circular: bool = False
                         ) -> torch.Tensor:
    """Source content in the target's style: the 2-D FFT amplitude of
    ``src`` (B, C, H, W) with its low frequencies replaced by ``trg``'s,
    ``src``'s phase, inverse FFT, real part; in ``src.dtype``."""
    fft_src = torch.fft.fft2(src.float())
    amp_trg = torch.fft.fft2(trg.float()).abs()
    mask = _swap_mask(src.shape[-2], src.shape[-1], beta, use_circular,
                      src.device)
    amp = torch.where(mask, amp_trg, fft_src.abs())
    mixed = torch.polar(amp, fft_src.angle())
    return torch.fft.ifft2(mixed).real.to(src.dtype)
