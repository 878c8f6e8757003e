"""CenterNet detection loss (NCHW heads).

Counterpart of ``centernet_uda_tpu/losses/centernet.py`` (the reference's
``losses/centernet.py``): the CornerNet focal loss on the heatmap and the
masked L1 regression of size and offset at the ``ind`` centers, with
the periodic (RAPiD) angle loss for rotated boxes and the keypoint offset
loss with its pairwise-distance term. Under data parallelism
(``parallel/ddp.py``) each normalizer counts over the global batch, so a
rank's loss is its share of the global batch's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch

from centernet_uda_torch.ops.tensor import (
    gather_features_nchw,
    sigmoid_clamped,
)
from centernet_uda_torch.parallel.ddp import global_sum


def focal_loss(pred: torch.Tensor, gt: torch.Tensor,
               weight: float = 1.0) -> torch.Tensor:
    """CornerNet-modified focal loss on the sigmoided heatmap ``pred``.

    Positives are pixels with ``gt == 1``; negatives are weighted by
    ``(1 - gt)^4``. Normalized by the positive count; without positives the
    loss is the raw negative sum. Across ranks the count is the global
    batch's and the loss this rank's share (``parallel/ddp.py``).
    """
    pred = pred.float()
    gt = gt.float()
    pos = (gt == 1.0).float()
    neg = (gt < 1.0).float()
    neg_weights = torch.pow(1.0 - gt, 4)
    pos_sum = (torch.log(pred) * torch.pow(1.0 - pred, 2) * pos).sum()
    neg_sum = (torch.log(1.0 - pred) * torch.pow(pred, 2) * neg_weights
               * neg).sum()
    num_pos = global_sum(pos.sum())
    loss = torch.where(num_pos == 0, -neg_sum,
                       -(pos_sum + neg_sum) / torch.clamp(num_pos, min=1.0))
    return loss * weight


def _mask_norm(mask: torch.Tensor) -> torch.Tensor:
    """The L1 terms' normalizer, ``mask.sum() + 1e-4`` (the mask counts
    elements, objects x channels, as in the reference), the mask summed
    over the ranks."""
    return global_sum(mask.sum()) + 1e-4


def _masked_l1(pred: torch.Tensor, target: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Sum of |pred*mask - target*mask| over ``_mask_norm(mask)``."""
    return (pred * mask - target * mask).abs().sum() / _mask_norm(mask)


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
        norm = _mask_norm(m)
        wh_loss = (pred[..., 0:2] * m[..., 0:2]
                   - target[..., 0:2] * m[..., 0:2]).abs().sum() / norm
        a_pred = sigmoid_clamped(pred[..., 2:3] * m[..., 2:3])
        a_tgt = sigmoid_clamped(target[..., 2:3] * m[..., 2:3])
        a_loss = (a_pred - a_tgt).abs().sum() / norm
        return wh_loss * weight + a_loss * angle_weight
    return _masked_l1(pred, target, m) * weight


def periodic_reg_l1_loss(output: torch.Tensor, mask: torch.Tensor,
                         ind: torch.Tensor, target: torch.Tensor,
                         wh_weight: float = 1.0, angle_weight: float = 1.0,
                         pred: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RAPiD periodic angle loss: masked L1 on the two size channels; the
    angle maps the prediction through ``sigmoid * 2pi - pi`` and the target
    from degrees to radians and costs ``|((d - pi/2) mod pi) - pi/2|``,
    the mod taking the divisor's sign (``torch.remainder``, as
    ``jnp.mod``; ``torch.fmod`` would take the dividend's)."""
    if pred is None:
        pred = gather_features_nchw(output.float(), ind)
    m = mask.unsqueeze(-1).float().expand_as(pred)
    pred = pred * m
    target = target.float() * m
    norm = _mask_norm(m)
    wh_loss = (pred[..., 0:2] - target[..., 0:2]).abs().sum() / norm
    pred_angle = sigmoid_clamped(pred[..., 2:3]) * 2.0 * math.pi - math.pi
    target_angle = torch.deg2rad(target[..., 2:3])
    periodic = (torch.remainder((pred_angle - target_angle) - math.pi / 2.0,
                                math.pi) - math.pi / 2.0).abs()
    return wh_loss * wh_weight + periodic.sum() / norm * angle_weight


def kps_l1_loss(output: torch.Tensor, mask: torch.Tensor, ind: torch.Tensor,
                target: torch.Tensor, weight: float = 1.0,
                kp_indices=None,
                distance_weight: float = 0.1, use_l1_distance: bool = False,
                legacy_sqrt_bias: bool = True,
                pred: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Keypoint offset L1 at the centers, plus with ``kp_indices`` the L1
    between predicted and target distances of the listed keypoint pairs
    (a sequence of pairs, or their (P, 2) index tensor).
    ``mask`` is the per-coordinate ``kp_reg_mask`` (B, K, 2P). The L2
    distance adds ``1e4`` inside the square root as the reference does
    (``legacy_sqrt_bias``; ``1e-4`` otherwise)."""
    if pred is None:
        pred = gather_features_nchw(output.float(), ind)
    m = mask.float()
    pred = pred * m
    target = target.float() * m
    norm = _mask_norm(m)
    loss = (pred - target).abs().sum() / norm * weight
    if kp_indices is not None:
        idx = torch.as_tensor(kp_indices, dtype=torch.long,
                              device=pred.device)
        n, k2 = pred.shape[0], pred.shape[-1]
        p = pred.reshape(n, -1, k2 // 2, 2)
        t = target.reshape(n, -1, k2 // 2, 2)
        p_a, p_b = p[:, :, idx[:, 0]], p[:, :, idx[:, 1]]
        t_a, t_b = t[:, :, idx[:, 0]], t[:, :, idx[:, 1]]
        if use_l1_distance:
            pred_d = (p_a - p_b).abs().sum(-1)
            tgt_d = (t_a - t_b).abs().sum(-1)
        else:
            bias = 1e4 if legacy_sqrt_bias else 1e-4
            pred_d = torch.sqrt(((p_a - p_b) ** 2).sum(-1) + bias)
            tgt_d = torch.sqrt(((t_a - t_b) ** 2).sum(-1) + bias)
        loss = loss + (pred_d - tgt_d).abs().sum() / norm * distance_weight
    return loss


@dataclass
class DetectionLoss:
    """Composite CenterNet loss: ``(outputs, batch) -> (loss, stats)``.

    ``outputs`` is the head dict (NCHW, raw ``hm`` logits); it is not
    mutated, decode applies its own sigmoid. ``periodic`` takes the
    periodic angle loss for the rotated ``wh``; ``kp_weight`` or
    ``kp_indices`` adds the keypoint loss (``kp_loss`` in the stats).
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
    # kp_indices on each device, made once: a copy from the host inside a
    # captured step (utils/graphs.py) is not allowed
    _kp_index: Dict[torch.device, torch.Tensor] = field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def with_keypoints(self) -> bool:
        return self.kp_weight is not None or self.kp_indices is not None

    def _kp_indices(self, device: torch.device) -> Optional[torch.Tensor]:
        if self.kp_indices is None:
            return None
        if device not in self._kp_index:
            self._kp_index[device] = torch.as_tensor(
                self.kp_indices, dtype=torch.long, device=device)
        return self._kp_index[device]

    def __call__(self, outputs: Dict[str, torch.Tensor],
                 batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        hm_loss = focal_loss(sigmoid_clamped(outputs["hm"]), batch["hm"],
                             self.hm_weight)
        # one gather for every regression head at the shared ``ind``, in
        # the channel order kps, reg, wh
        heads = ([outputs["kps"]] if self.with_keypoints else []) + [
            outputs["reg"], outputs["wh"]]
        gathered = gather_features_nchw(torch.cat(heads, 1).float(),
                                        batch["ind"])
        d_wh = outputs["wh"].shape[1]
        wh_loss_fn = periodic_reg_l1_loss if self.periodic else reg_l1_loss
        wh_loss = wh_loss_fn(outputs["wh"], batch["reg_mask"], batch["ind"],
                             batch["wh"], self.wh_weight, self.angle_weight,
                             pred=gathered[..., -d_wh:])
        off_loss = reg_l1_loss(outputs["reg"], batch["reg_mask"],
                               batch["ind"], batch["reg"], self.off_weight,
                               pred=gathered[..., -d_wh - 2:-d_wh])
        loss = hm_loss + wh_loss + off_loss
        stats = {"hm_loss": hm_loss, "wh_loss": wh_loss, "off_loss": off_loss}
        if self.with_keypoints:
            kp_loss = kps_l1_loss(
                outputs["kps"], batch["kp_reg_mask"], batch["ind"],
                batch["kps"],
                weight=1.0 if self.kp_weight is None else self.kp_weight,
                kp_indices=self._kp_indices(gathered.device),
                distance_weight=self.kp_distance_weight,
                use_l1_distance=self.kp_distance_weight_l1,
                legacy_sqrt_bias=self.legacy_sqrt_bias,
                pred=gathered[..., :-d_wh - 2])
            loss = loss + kp_loss
            stats["kp_loss"] = kp_loss
        stats["centernet_loss"] = loss
        return loss, stats
