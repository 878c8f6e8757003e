"""CenterNet detection loss (NCHW heads).

Counterpart of ``centernet_uda_tpu/losses/centernet.py`` (the reference's
``losses/centernet.py``): the CornerNet focal loss on the heatmap and the
masked L1 regression of size and offset at the ``ind`` centers. The
periodic angle loss and the keypoint loss are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from centernet_uda_torch.ops.tensor import (
    gather_features_nchw,
    sigmoid_clamped,
)


def focal_loss(pred: torch.Tensor, gt: torch.Tensor,
               weight: float = 1.0) -> torch.Tensor:
    """CornerNet-modified focal loss on the sigmoided heatmap ``pred``.

    Positives are pixels with ``gt == 1``; negatives are weighted by
    ``(1 - gt)^4``. Normalized by the positive count; without positives the
    loss is the raw negative sum.
    """
    pred = pred.float()
    gt = gt.float()
    pos = (gt == 1.0).float()
    neg = (gt < 1.0).float()
    neg_weights = torch.pow(1.0 - gt, 4)
    pos_sum = (torch.log(pred) * torch.pow(1.0 - pred, 2) * pos).sum()
    neg_sum = (torch.log(1.0 - pred) * torch.pow(pred, 2) * neg_weights
               * neg).sum()
    num_pos = pos.sum()
    loss = torch.where(num_pos == 0, -neg_sum,
                       -(pos_sum + neg_sum) / torch.clamp(num_pos, min=1.0))
    return loss * weight


def _masked_l1(pred: torch.Tensor, target: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Sum of |pred*mask - target*mask| over ``mask.sum() + 1e-4`` (the mask
    counts elements, objects x channels, as in the reference)."""
    return (pred * mask - target * mask).abs().sum() / (mask.sum() + 1e-4)


def reg_l1_loss(output: torch.Tensor, mask: torch.Tensor, ind: torch.Tensor,
                target: torch.Tensor, weight: float = 1.0,
                angle_weight: float = 1.0,
                pred: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked L1 at the gt centers. ``output`` (B, D, H, W), ``mask`` and
    ``ind`` (B, K), ``target`` (B, K, D). For D == 3 the last channel is an
    angle: the reference sigmoids both the prediction and the target angle
    after masking, and both terms share the 3-channel normaliser."""
    if pred is None:
        pred = gather_features_nchw(output.float(), ind)
    m = mask.unsqueeze(-1).float().expand_as(pred)
    target = target.float()
    if pred.shape[-1] == 3:
        norm = m.sum() + 1e-4
        wh_loss = (pred[..., 0:2] * m[..., 0:2]
                   - target[..., 0:2] * m[..., 0:2]).abs().sum() / norm
        a_pred = sigmoid_clamped(pred[..., 2:3] * m[..., 2:3])
        a_tgt = sigmoid_clamped(target[..., 2:3] * m[..., 2:3])
        a_loss = (a_pred - a_tgt).abs().sum() / norm
        return wh_loss * weight + a_loss * angle_weight
    return _masked_l1(pred, target, m) * weight


@dataclass
class DetectionLoss:
    """Composite CenterNet loss: ``(outputs, batch) -> (loss, stats)``.

    ``outputs`` is the head dict (NCHW, raw ``hm`` logits); it is not
    mutated, decode applies its own sigmoid. Periodic angles and keypoints
    raise ``NotImplementedError``.
    """

    hm_weight: float = 1.0
    wh_weight: float = 0.1
    off_weight: float = 1.0
    kp_weight: Optional[float] = None
    angle_weight: float = 1.0
    periodic: bool = False
    kp_indices: Optional[Sequence[Sequence[int]]] = None
    kp_distance_weight: float = 0.1
    kp_distance_weight_l1: bool = False
    legacy_sqrt_bias: bool = True

    def __post_init__(self):
        if self.periodic:
            raise NotImplementedError(
                "the periodic angle loss is not ported yet (ROADMAP A3)")
        if self.kp_weight is not None or self.kp_indices is not None:
            raise NotImplementedError(
                "the keypoint loss is not ported yet (ROADMAP A3)")

    def __call__(self, outputs: Dict[str, torch.Tensor],
                 batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        hm_loss = focal_loss(sigmoid_clamped(outputs["hm"]), batch["hm"],
                             self.hm_weight)
        # one gather for both regression heads at the shared ``ind``
        d_wh = outputs["wh"].shape[1]
        gathered = gather_features_nchw(
            torch.cat([outputs["reg"], outputs["wh"]], 1).float(),
            batch["ind"])
        wh_loss = reg_l1_loss(outputs["wh"], batch["reg_mask"], batch["ind"],
                              batch["wh"], self.wh_weight, self.angle_weight,
                              pred=gathered[..., -d_wh:])
        off_loss = reg_l1_loss(outputs["reg"], batch["reg_mask"],
                               batch["ind"], batch["reg"], self.off_weight,
                               pred=gathered[..., :-d_wh])
        loss = hm_loss + wh_loss + off_loss
        stats = {"hm_loss": hm_loss, "wh_loss": wh_loss, "off_loss": off_loss,
                 "centernet_loss": loss}
        return loss, stats
