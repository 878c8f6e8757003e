"""Baseline (no-UDA) trainer.

Counterpart of ``centernet_uda_tpu/uda/base.py`` (the reference's
``uda/base.py``) with the lifecycle hooks the main path uses: ``init_done``,
``step``, ``epoch_end``, ``get_detections``. The train step is forward,
``DetectionLoss``, ``backward()`` and one optimizer step on train-mode
BatchNorm; the eval step runs under ``no_grad`` with eval-mode BatchNorm.
Checkpointing waits for ROADMAP A4.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from centernet_uda_torch import resolve_device
from centernet_uda_torch.ops.dcn import DCN, PALLAS_MAX_SHIFT
from centernet_uda_torch.ops.decode import decode_detections
from centernet_uda_torch.utils import optim as optim_util

log = logging.getLogger(__name__)

# host-side ground truth that get_detections reads; never sent to the device
_HOST_KEYS = ("gt_dets", "gt_areas", "gt_kps", "id")


class Model:
    """No-UDA trainer; ``train.build_trainer`` sets ``cfg``, ``backend``,
    ``centernet_loss``, ``optimizer_cfg`` and ``scheduler`` before
    ``init_done()``."""

    cfg = None
    backend = None
    centernet_loss = None
    optimizer_cfg: Optional[Dict[str, Any]] = None
    scheduler = None

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.base_lr: float = 0.0
        self.epoch: int = 0

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def init_done(self):
        net = self.backend.module.to(self.device)
        opt_name, opt_params = self._optimizer_config()
        self.base_lr = float(opt_params.get("lr", 1e-3))
        self.optimizer = optim_util.make_optimizer(opt_name, opt_params,
                                                   net.parameters())
        n_params = sum(p.numel() for p in net.parameters())
        log.info("initialized %s: %.2fM params on %s", self.backend.name,
                 n_params / 1e6, self.device)

    def _optimizer_config(self) -> Tuple[str, Dict[str, Any]]:
        if self.optimizer_cfg is None:
            return "Adam", {"lr": 5e-5}
        return (self.optimizer_cfg.get("name", "Adam"),
                dict(self.optimizer_cfg.get("params", {}) or {}))

    def epoch_end(self):
        """Per-epoch LR schedule step."""
        self.epoch += 1
        if self.scheduler is not None and self.optimizer is not None:
            optim_util.set_learning_rate(
                self.optimizer, self.scheduler.lr(self.epoch, self.base_lr))

    def _dcn_modules(self):
        return [m for m in self.backend.module.modules()
                if isinstance(m, DCN)]

    def maybe_degrade_dcn(self, max_abs_dy: float) -> bool:
        """Switch every DCN to the exact op once the monitored
        ``dcn_max_abs_dy`` reaches the kernels' vertical clamp
        (``PALLAS_MAX_SHIFT``): from there the kernels truncate, while the
        reference sampler is unbounded. Returns True when it switched."""
        mods = [m for m in self._dcn_modules() if m.impl != "xla"]
        if not mods or max_abs_dy < PALLAS_MAX_SHIFT:
            return False
        for m in mods:
            m.impl = "xla"
        log.error(
            "DCN vertical offsets reached %.1f px, AT the kernel clamp "
            "(max_shift=%d): sampling was truncating. Switched this run to "
            "the exact DCN op (unbounded offsets).", max_abs_dy,
            PALLAS_MAX_SHIFT)
        return True

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------
    def _apply_backend(self, x: torch.Tensor, train: bool
                       ) -> Dict[str, torch.Tensor]:
        net = self.backend.module
        net.train(train)
        outputs = dict(net(x))
        dys = [m.max_abs_dy for m in self._dcn_modules()
               if m.max_abs_dy is not None]
        if dys:
            outputs["_dcn_max_abs_dy"] = torch.stack(dys).amax()
        return outputs

    def loss_terms(self, batch, train: bool):
        """Total loss and ``(outputs_by_domain, stats)``."""
        outputs_src = self._apply_backend(batch["input"], train)
        loss, stats = self.centernet_loss(outputs_src, batch)
        return loss, ({"source_domain": outputs_src}, stats)

    @staticmethod
    def _fold_clamp_stats(outputs, stats):
        """Move the DCN clamp monitor out of the head dicts into the
        stats."""
        clamp = [dom.pop("_dcn_max_abs_dy") for dom in outputs.values()
                 if isinstance(dom, dict) and "_dcn_max_abs_dy" in dom]
        if clamp:
            stats["dcn_max_abs_dy"] = torch.stack(clamp).amax()

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        self.optimizer.zero_grad(set_to_none=True)
        loss, (outputs, stats) = self.loss_terms(batch, True)
        loss.backward()
        self.optimizer.step()
        stats = {k: v.detach() for k, v in stats.items()}
        stats["total_loss"] = loss.detach()
        self._fold_clamp_stats(outputs, stats)
        return stats

    @torch.no_grad()
    def eval_step(self, batch):
        loss, (outputs, stats) = self.loss_terms(batch, False)
        stats = dict(stats)
        stats["total_loss"] = loss
        self._fold_clamp_stats(outputs, stats)
        return outputs, stats

    def _device_batch(self, data) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in data.items()
                if isinstance(v, (np.ndarray, torch.Tensor))
                and k not in _HOST_KEYS}

    def step(self, data, is_training: bool = True):
        batch = self._device_batch(data)
        if is_training:
            return {"stats": self.train_step(batch)}
        outputs, stats = self.eval_step(batch)
        outputs = dict(outputs)
        outputs["stats"] = stats
        return outputs

    def decode(self, outputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.backend.rotated_boxes or "kps" in outputs:
            raise NotImplementedError(
                "rotated and keypoint decode are not ported yet (ROADMAP A5)")
        k = int(self.cfg.get("max_detections", 150)) if self.cfg else 100
        return decode_detections(outputs["hm"], outputs["wh"],
                                 outputs.get("reg"), k=k, apply_sigmoid=True)

    @torch.no_grad()
    def get_detections(self, outputs, batch) -> Dict[str, Any]:
        """Decode + unpack detections for the evaluator."""
        down_ratio = self.backend.down_ratio
        dets = self.decode(outputs["source_domain"]).cpu().numpy().copy()
        dets[:, :, :4] *= down_ratio

        def host(v):
            return v.cpu().numpy() if isinstance(v, torch.Tensor) else \
                np.asarray(v)

        ids = host(batch["id"])
        mask = host(batch["reg_mask"]) == 1
        dets_gt = host(batch["gt_dets"]).copy()
        areas_gt = host(batch["gt_areas"])
        dets_gt[:, :, :4] *= down_ratio
        gt_boxes, gt_clss, gt_ids, gt_areas = [], [], [], []
        for i in range(dets_gt.shape[0]):
            det_gt = dets_gt[i, mask[i]]
            gt_boxes.append(det_gt[:, :4])
            gt_clss.append(det_gt[:, 5].astype(np.int32))
            gt_ids.append(ids[i])
            gt_areas.append(areas_gt[i, mask[i]])
        return {
            "pred_boxes": dets[:, :, :4],
            "pred_classes": dets[:, :, 5].astype(np.int32),
            "pred_scores": dets[:, :, 4],
            "gt_boxes": gt_boxes,
            "gt_classes": gt_clss,
            "gt_ids": gt_ids,
            "gt_areas": gt_areas,
        }
