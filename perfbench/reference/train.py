"""The reference's losses, optimizer and decode, plain PyTorch.

- ``detection_loss``: the reference project's ``losses/centernet.py``: the
  CornerNet focal loss on the clamped sigmoid of the heatmap (positives
  where the target is 1, negatives weighted by (1 - gt)^4, over the
  positive count), and the masked L1 of size and offset at the ``ind``
  centers over ``mask.sum() + 1e-4`` (the mask counted per channel).
  A rotated ``wh`` (3 channels: width, height, angle in degrees) adds its
  angle term to ``wh_loss`` under ``angle_weight``, over the 3-channel
  count: with ``periodic`` RAPiD's periodic L1, the prediction
  ``sigmoid * 2 pi - pi`` against the target in radians, costing
  ``|((d - pi/2) mod pi) - pi/2|`` (the mod taking the divisor's sign);
  without it the L1 of the clamped sigmoids of prediction and target. A
  ``kps`` head adds ``kp_loss``: the L1 of the center-relative keypoint
  offsets under the per-coordinate ``kp_reg_mask``, over its count, times
  ``kp_weight``, and with ``kp_indices`` the L1 of the listed pairs'
  distances over the same count times ``kp_distance_weight`` (Euclidean
  with 1e4 under the square root, as the reference project has it, or
  with ``kp_distance_weight_l1`` the L1 distance).
- ``entropy_loss``: ``losses/entropy.py``: the Shannon entropy (base 2) of
  the heatmap's softmax over the classes, over ``n * h * w * log2(C)``.
- ``Adam``: ``torch.optim.Adam``'s arithmetic with coupled L2 weight decay
  (``g + wd * p`` feeds the moments), written out.
- ``top_detections``: ``backends/decode.py``: 3x3 peak suppression, the
  top k peaks over all classes, boxes from the size and offset heads
  (rotated: center, size and the angle ``sigmoid * 360 - 180`` degrees),
  and with a ``kps`` head the keypoints at the peaks: the offsets plus the
  center.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.sigmoid(x), 1e-4, 1.0 - 1e-4)


def _gather(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) features at the flat indices ind (B, K) -> (B, K, C)."""
    b, c = feat.shape[:2]
    flat = feat.reshape(b, c, -1)
    return torch.gather(flat, 2, ind.long().unsqueeze(1).expand(b, c, -1)
                        ).transpose(1, 2)


def detection_loss(heads: Dict[str, torch.Tensor], batch,
                   weights: Dict[str, float]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    pred = _sigmoid(heads["hm"])
    gt = batch["hm"].float()
    pos = (gt == 1.0).float()
    neg = (gt < 1.0).float()
    pos_sum = (torch.log(pred) * (1 - pred) ** 2 * pos).sum()
    neg_sum = (torch.log(1 - pred) * pred ** 2 * (1 - gt) ** 4 * neg).sum()
    num_pos = pos.sum()
    hm = torch.where(num_pos == 0, -neg_sum,
                     -(pos_sum + neg_sum) / num_pos.clamp(min=1.0))
    mask = batch["reg_mask"].float().unsqueeze(-1).expand(-1, -1, 2)
    norm = mask.sum() + 1e-4

    def l1(name):
        p = _gather(heads[name].float(), batch["ind"])
        t = batch[name].float()
        return (p * mask - t * mask).abs().sum() / norm

    terms = {"hm_loss": hm * weights["hm_weight"],
             "wh_loss": (l1("wh") * weights["wh_weight"]
                         if heads["wh"].shape[1] == 2 else
                         rotated_size_loss(heads["wh"], batch, weights)),
             "off_loss": l1("reg") * weights["off_weight"]}
    total = terms["hm_loss"] + terms["wh_loss"] + terms["off_loss"]
    if "kps" in heads:
        terms["kp_loss"] = keypoint_loss(heads["kps"], batch, weights)
        total = total + terms["kp_loss"]
    return total, terms


def rotated_size_loss(wh: torch.Tensor, batch, weights: Dict[str, float]
                      ) -> torch.Tensor:
    """Width, height and angle at the centers: the size's L1 times
    ``wh_weight`` plus the angle term times ``angle_weight``, both over the
    3-channel mask count."""
    mask = batch["reg_mask"].float().unsqueeze(-1).expand(-1, -1, 3)
    norm = mask.sum() + 1e-4
    pred = _gather(wh.float(), batch["ind"]) * mask
    target = batch["wh"].float() * mask
    size = (pred[..., :2] - target[..., :2]).abs().sum() / norm
    if weights.get("periodic", False):
        d = (_sigmoid(pred[..., 2]) * 2 * math.pi - math.pi
             - torch.deg2rad(target[..., 2]))
        angle = (torch.remainder(d - math.pi / 2, math.pi)
                 - math.pi / 2).abs()
    else:
        angle = (_sigmoid(pred[..., 2]) - _sigmoid(target[..., 2])).abs()
    return (size * weights["wh_weight"]
            + angle.sum() / norm * weights["angle_weight"])


def keypoint_loss(kps: torch.Tensor, batch, weights: Dict[str, float]
                  ) -> torch.Tensor:
    """The keypoint offsets' L1 at the centers, and the pair-distance term
    of ``kp_indices``, over the count of visible coordinates."""
    mask = batch["kp_reg_mask"].float()
    norm = mask.sum() + 1e-4
    pred = _gather(kps.float(), batch["ind"]) * mask
    target = batch["kps"].float() * mask
    loss = (pred - target).abs().sum() / norm * weights["kp_weight"]
    pairs = weights.get("kp_indices")
    if not pairs:
        return loss
    b, n, c = pred.shape
    pairs = torch.tensor(pairs, device=pred.device)

    def distances(t):
        t = t.reshape(b, n, c // 2, 2)
        d = t[:, :, pairs[:, 0]] - t[:, :, pairs[:, 1]]
        if weights.get("kp_distance_weight_l1", False):
            return d.abs().sum(-1)
        return torch.sqrt((d * d).sum(-1) + 1e4)

    gap = (distances(pred) - distances(target)).abs().sum()
    return loss + gap / norm * weights["kp_distance_weight"]


def entropy_loss(hm: torch.Tensor) -> torch.Tensor:
    v = torch.softmax(hm.float(), dim=1)
    n, c, h, w = v.shape
    return -(v * torch.log2(v + 1e-30)).sum() / (n * h * w * math.log2(c))


class Adam:
    """Adam with coupled weight decay over a list of leaves."""

    def __init__(self, params: List[torch.Tensor], lr: float,
                 weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = params
        self.lr, self.wd, self.eps = float(lr), float(weight_decay), eps
        self.b1, self.b2 = betas
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[Optional[torch.Tensor]]
             ) -> List[Optional[torch.Tensor]]:
        """One update; returns the gradients as the moments took them. A
        leaf without a gradient (None: no loss reaches it) is left as it
        is, moments and weight decay included."""
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        fed = []
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            if g is None:
                fed.append(None)
                continue
            g = g + self.wd * p
            fed.append(g)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))
        return fed


def top_detections(heads: Dict[str, torch.Tensor], k: int, down_ratio: int
                   ) -> Dict[str, torch.Tensor]:
    """The k highest peaks of each image: ``boxes`` (B, k, 4) ``[x1, y1,
    x2, y2]`` in input pixels (rotated: (B, k, 5) ``[cx, cy, w, h,
    angle]``), ``scores``, ``classes`` and ``positions`` (flat map indices
    ``y * W + x``) (B, k), and with a ``kps`` head ``kps`` (B, k, P, 2)
    in input pixels."""
    heat = _sigmoid(heads["hm"].float())
    b, c, h, w = heat.shape
    peak = F.max_pool2d(heat, 3, 1, 1) == heat
    scores, flat = torch.topk(torch.where(peak, heat, torch.zeros_like(heat))
                              .reshape(b, -1), k)
    classes = flat // (h * w)
    pos = flat % (h * w)
    boxes = boxes_at(heads, pos, down_ratio)
    out = {"boxes": boxes, "scores": scores, "classes": classes,
           "positions": pos}
    if "kps" in heads:
        out["kps"] = keypoints_at(heads, pos, down_ratio)
    return out


def _centers(heads: Dict[str, torch.Tensor], pos: torch.Tensor):
    """The centers (x, y), each (B, N), in map cells at the flat map
    positions pos (B, N): the cell plus its offset."""
    w = heads["hm"].shape[-1]
    reg = _gather(heads["reg"].float(), pos)
    return (pos % w).float() + reg[..., 0], (pos // w).float() + reg[..., 1]


def boxes_at(heads: Dict[str, torch.Tensor], pos: torch.Tensor,
             down_ratio: int) -> torch.Tensor:
    """Boxes (B, N, 4) in input pixels at the flat map positions pos
    (B, N); rotated (B, N, 5), the angle in degrees."""
    xs, ys = _centers(heads, pos)
    wh = _gather(heads["wh"].float(), pos)
    if wh.shape[-1] == 3:
        angle = _sigmoid(wh[..., 2]) * 360.0 - 180.0
        return torch.cat((torch.stack((xs, ys, wh[..., 0], wh[..., 1]), -1)
                          * down_ratio, angle[..., None]), -1)
    return torch.stack((xs - wh[..., 0] / 2, ys - wh[..., 1] / 2,
                        xs + wh[..., 0] / 2, ys + wh[..., 1] / 2),
                       -1) * down_ratio


def keypoints_at(heads: Dict[str, torch.Tensor], pos: torch.Tensor,
                 down_ratio: int) -> torch.Tensor:
    """Keypoints (B, N, P, 2) in input pixels at the flat map positions pos
    (B, N): the ``kps`` head's offsets plus the center."""
    xs, ys = _centers(heads, pos)
    kps = _gather(heads["kps"].float(), pos)
    b, n, c = kps.shape
    return (kps.reshape(b, n, c // 2, 2)
            + torch.stack((xs, ys), -1)[:, :, None]) * down_ratio
