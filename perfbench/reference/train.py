"""The reference's losses, optimizer and decode, plain PyTorch.

- ``detection_loss``: the reference project's ``losses/centernet.py``: the
  CornerNet focal loss on the clamped sigmoid of the heatmap (positives
  where the target is 1, negatives weighted by (1 - gt)^4, over the
  positive count), and the masked L1 of size and offset at the ``ind``
  centers over ``mask.sum() + 1e-4`` (the mask counted per channel).
- ``entropy_loss``: ``losses/entropy.py``: the Shannon entropy (base 2) of
  the heatmap's softmax over the classes, over ``n * h * w * log2(C)``.
- ``Adam``: ``torch.optim.Adam``'s arithmetic with coupled L2 weight decay
  (``g + wd * p`` feeds the moments), written out.
- ``top_detections``: ``backends/decode.py``: 3x3 peak suppression, the
  top k peaks over all classes, boxes from the size and offset heads.
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
             "wh_loss": l1("wh") * weights["wh_weight"],
             "off_loss": l1("reg") * weights["off_weight"]}
    total = terms["hm_loss"] + terms["wh_loss"] + terms["off_loss"]
    return total, terms


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
    x2, y2]`` in input pixels, ``scores``, ``classes`` and ``positions``
    (flat map indices ``y * W + x``) (B, k)."""
    heat = _sigmoid(heads["hm"].float())
    b, c, h, w = heat.shape
    peak = F.max_pool2d(heat, 3, 1, 1) == heat
    scores, flat = torch.topk(torch.where(peak, heat, torch.zeros_like(heat))
                              .reshape(b, -1), k)
    classes = flat // (h * w)
    pos = flat % (h * w)
    boxes = boxes_at(heads, pos, down_ratio)
    return {"boxes": boxes, "scores": scores, "classes": classes,
            "positions": pos}


def boxes_at(heads: Dict[str, torch.Tensor], pos: torch.Tensor,
             down_ratio: int) -> torch.Tensor:
    """Boxes (B, N, 4) in input pixels at the flat map positions pos
    (B, N)."""
    w = heads["hm"].shape[-1]
    reg = _gather(heads["reg"].float(), pos)
    wh = _gather(heads["wh"].float(), pos)
    xs = (pos % w).float() + reg[..., 0]
    ys = (pos // w).float() + reg[..., 1]
    return torch.stack((xs - wh[..., 0] / 2, ys - wh[..., 1] / 2,
                        xs + wh[..., 0] / 2, ys + wh[..., 1] / 2),
                       -1) * down_ratio
