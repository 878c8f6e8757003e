"""Deformable PS-RoI pooling (DCNv2Pooling / DCNPooling), NCHW.

Counterpart of ``centernet_uda_tpu/ops/dcn_pooling.py`` (the reference's
pooling half of the DCNv2 extension, ``libs/DCNv2/dcn_v2.py:130-303``, CUDA
kernel ``DeformablePSROIPoolForwardKernelCuda``). No reference backend or
experiment uses it; the JAX package computes it with plain XLA gathers over
a fixed sample grid and autodiff, so plain PyTorch ops with autograd are its
port (there is no TPU kernel to replace).

Layouts: ``x`` (B, C, H, W) with ``C == output_dim * group_size**2``;
``rois`` (N, 5) rows ``[batch_index, x1, y1, x2, y2]`` in input-image
coordinates; ``trans`` (N, 2 * num_classes, part_size, part_size), ignored
when ``no_trans``; the pooled output (N, output_dim, pooled_size,
pooled_size) (the JAX package returns it channels-last).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from centernet_uda_torch.models.common import lecun_normal_


def dcn_v2_pooling(x: torch.Tensor, rois: torch.Tensor,
                   trans: Optional[torch.Tensor], spatial_scale: float,
                   pooled_size: int, output_dim: int, no_trans: bool,
                   group_size: int = 1, part_size: Optional[int] = None,
                   sample_per_part: int = 4,
                   trans_std: float = 0.0) -> torch.Tensor:
    """Deformable position-sensitive RoI average pooling, differentiable in
    ``x`` and ``trans``.

    The CUDA kernel's semantics: rounded RoI corners scaled by
    ``spatial_scale`` with the -0.5 centre shift, an extent of at least
    0.1, per bin ``sample_per_part ** 2`` bilinear samples averaged over
    those inside the map (a bin with none is 0), the position-sensitive
    channel ``(ctop * G + gh) * G + gw``, and per-part offsets scaled by
    ``trans_std`` and the RoI's extent.
    """
    b, c, h, w = x.shape
    g, ps, sp = group_size, pooled_size, sample_per_part
    part = ps if part_size is None else part_size
    if c != output_dim * g * g:
        raise ValueError(f"x has {c} channels, not output_dim * "
                         f"group_size**2 = {output_dim * g * g}")
    num_classes = 1 if no_trans else trans.shape[1] // 2
    channels_each_class = max(output_dim // num_classes, 1)
    dev = x.device

    rois = rois.float()
    batch_idx = rois[:, 0].long()  # (N,)
    start_w = torch.round(rois[:, 1]) * spatial_scale - 0.5
    start_h = torch.round(rois[:, 2]) * spatial_scale - 0.5
    end_w = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    end_h = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    roi_w = torch.clamp(end_w - start_w, min=0.1)
    roi_h = torch.clamp(end_h - start_h, min=0.1)
    bin_w, bin_h = roi_w / ps, roi_h / ps
    sub_w, sub_h = bin_w / sp, bin_h / sp

    bins = torch.arange(ps, device=dev)
    part_idx = torch.floor(bins / ps * part).long()  # (PS,)

    if no_trans:
        trans_x = trans_y = torch.zeros((), device=dev)
    else:
        cls = torch.arange(output_dim, device=dev) // channels_each_class
        per_part = trans.float()[:, :, part_idx][:, :, :, part_idx]
        trans_x = per_part[:, cls * 2] * trans_std  # (N, OD, PS, PS)
        trans_y = per_part[:, cls * 2 + 1] * trans_std

    # sample coordinates (N, OD, PS(h), PS(w), SP(h), SP(w))
    wstart = bins[None] * bin_w[:, None] + start_w[:, None]  # (N, PS)
    hstart = bins[None] * bin_h[:, None] + start_h[:, None]
    wstart = wstart[:, None, None, :] + trans_x * roi_w[:, None, None, None]
    hstart = hstart[:, None, :, None] + trans_y * roi_h[:, None, None, None]
    wstart = wstart.expand(-1, output_dim, ps, ps)
    hstart = hstart.expand(-1, output_dim, ps, ps)
    steps = torch.arange(sp, device=dev)
    samp_w = (wstart[..., None, None] + steps[None, None]
              * sub_w[:, None, None, None, None, None])
    samp_h = (hstart[..., None, None] + steps[:, None]
              * sub_h[:, None, None, None, None, None])
    valid = ((samp_w >= -0.5) & (samp_w <= w - 0.5)
             & (samp_h >= -0.5) & (samp_h <= h - 0.5))
    cw = torch.clamp(samp_w, 0.0, w - 1.0)
    ch = torch.clamp(samp_h, 0.0, h - 1.0)

    # the position-sensitive channel of each (ctop, ph, pw): the group
    # cell of a bin is the same along h and w
    cell = torch.clamp(torch.floor(bins * g / ps).long(), 0, g - 1)
    ctop = torch.arange(output_dim, device=dev)
    chan = ((ctop[:, None, None] * g + cell[None, :, None]) * g
            + cell[None, None])
    # the (batch, channel) plane of every sample, as a flat plane index
    plane = (batch_idx[:, None, None, None] * c + chan[None])[..., None, None]

    flat = x.contiguous().reshape(-1)
    y0, x0 = torch.floor(ch), torch.floor(cw)
    dy, dx = ch - y0, cw - x0
    y0, x0 = y0.long(), x0.long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)

    def at(yy, xx):
        return flat[(plane * h + yy) * w + xx]

    vals = (at(y0, x0) * (1 - dy) * (1 - dx) + at(y0, x1) * (1 - dy) * dx
            + at(y1, x0) * dy * (1 - dx) + at(y1, x1) * dy * dx)
    vals = torch.where(valid, vals, torch.zeros((), device=dev))
    count = valid.sum((-1, -2))
    total = vals.sum((-1, -2))
    return torch.where(count > 0, total / torch.clamp(count, min=1),
                       torch.zeros((), device=dev))


class DCNv2Pooling(nn.Module):
    """``dcn_v2_pooling`` as a module (the reference's ``DCNv2Pooling``,
    ``dcn_v2.py:187-221``), with an explicit ``trans`` input."""

    def __init__(self, spatial_scale: float, pooled_size: int,
                 output_dim: int, no_trans: bool, group_size: int = 1,
                 part_size: Optional[int] = None, sample_per_part: int = 4,
                 trans_std: float = 0.0):
        super().__init__()
        self.spatial_scale = spatial_scale
        self.pooled_size = pooled_size
        self.output_dim = output_dim
        self.no_trans = no_trans
        self.group_size = group_size
        self.part_size = part_size
        self.sample_per_part = sample_per_part
        self.trans_std = trans_std

    def pool(self, x, rois, trans, no_trans: bool) -> torch.Tensor:
        return dcn_v2_pooling(
            x, rois, None if no_trans else trans, self.spatial_scale,
            self.pooled_size, self.output_dim, no_trans, self.group_size,
            self.part_size, self.sample_per_part, self.trans_std)

    def forward(self, x, rois, trans=None) -> torch.Tensor:
        return self.pool(x, rois, trans, self.no_trans)


class DCNPooling(DCNv2Pooling):
    """The reference's ``DCNPooling`` (``dcn_v2.py:224-303``): a pass
    without offsets feeds three fully connected layers (``fc1``, ``fc2``:
    ``deform_fc_dim`` wide with ReLU; ``fc3``: per-bin x and y offsets and
    a mask logit, zero-initialised), whose offsets drive a second,
    deformable pass scaled by the sigmoid of the mask. ``fc1`` reads the
    first pass flattened channel-major (N, output_dim * PS * PS), as the
    reference's ``view``; the JAX package flattens it channels-last, and
    ``utils/weights.py:pooling_state_dict_from_jax`` permutes its weights.
    Weights start as flax's (LeCun normal, zero bias) from ``generator``."""

    def __init__(self, spatial_scale: float, pooled_size: int,
                 output_dim: int, no_trans: bool, group_size: int = 1,
                 part_size: Optional[int] = None, sample_per_part: int = 4,
                 trans_std: float = 0.0, deform_fc_dim: int = 1024,
                 generator: Optional[torch.Generator] = None):
        super().__init__(spatial_scale, pooled_size, output_dim, no_trans,
                         group_size, part_size, sample_per_part, trans_std)
        if no_trans:
            return
        bins = pooled_size * pooled_size
        self.fc1 = nn.Linear(bins * output_dim, deform_fc_dim)
        self.fc2 = nn.Linear(deform_fc_dim, deform_fc_dim)
        self.fc3 = nn.Linear(deform_fc_dim, bins * 3)
        for fc in (self.fc1, self.fc2):
            lecun_normal_(fc.weight, generator)
            nn.init.zeros_(fc.bias)
        nn.init.zeros_(self.fc3.weight)
        nn.init.zeros_(self.fc3.bias)

    def forward(self, x, rois) -> torch.Tensor:
        base = self.pool(x, rois, None, True)
        if self.no_trans:
            return base
        n, ps = rois.shape[0], self.pooled_size
        z = torch.relu(self.fc1(base.reshape(n, -1)))
        z = torch.relu(self.fc2(z))
        z = self.fc3(z).reshape(n, 3, ps, ps)
        pooled = self.pool(x, rois, z[:, :2], False)
        return pooled * torch.sigmoid(z[:, 2:3])
