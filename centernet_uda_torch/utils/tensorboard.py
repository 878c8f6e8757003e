"""TensorBoard logging: a copy of ``centernet_uda_tpu/utils/tensorboard.py``
(the reference's utils/tensorboard.py).

The writer is tensorboardX's where tensorboardX imports, else
``torch.utils.tensorboard.SummaryWriter`` (the reference's own writer,
which needs the ``tensorboard`` package), and there is no writer (every
call returns at once) where neither imports; the import happens when a
logger is made, and the logger says which writer it took. Scalar keys
are identical (``training/*``, ``validation/*``, ``MSCOCO_*``) and the
first ``num_visualizations``
validation images per epoch are logged with pred|gt detection overlays
(the CHW input transposed to HWC for drawing).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

log = logging.getLogger(__name__)


class TensorboardLogger:
    def __init__(self, cfg, classes: Optional[Dict] = None, log_dir: str = "logs"):
        self.cfg = cfg
        self.classes = classes
        self.num_visualizations = int(
            cfg.get_dotted("tensorboard.num_visualizations", 50) if cfg else 50
        )
        self.score_threshold = float(
            cfg.get_dotted("tensorboard.score_threshold", 0.2) if cfg else 0.2
        )
        self._count = 0
        self._visualizer = None
        self.writer = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                log.info("neither tensorboardX nor tensorboard is "
                         "installed: no TensorBoard logs")
                return
        self.writer = SummaryWriter(log_dir)
        log.info("TensorBoard logs in %s through %s", log_dir,
                 SummaryWriter.__module__)

    def _get_visualizer(self):
        if self._visualizer is None:
            from centernet_uda_torch.utils.visualize import Visualizer

            mean = self.cfg.get_dotted("normalize.mean") if self.cfg else None
            std = self.cfg.get_dotted("normalize.std") if self.cfg else None
            self._visualizer = Visualizer(
                classes=self.classes,
                mean=mean,
                std=std,
                score_threshold=self.score_threshold,
            )
        return self._visualizer

    def log_detections(self, data, detections, epoch: int, tag: str = "validation"):
        if self.writer is None:
            return
        images = np.asarray(data["input"])
        rotated = detections["pred_boxes"].shape[-1] == 5
        viz = self._get_visualizer()
        # a padded final eval batch has fewer detections than images
        for i in range(min(images.shape[0], len(detections["pred_boxes"]))):
            if self._count >= self.num_visualizations:
                return
            canvas = viz.visualize_detections(
                images[i].transpose(1, 2, 0),
                detections["pred_boxes"][i],
                detections["pred_classes"][i],
                detections["pred_scores"][i],
                detections["gt_boxes"][i],
                detections["gt_classes"][i],
                rotated=rotated,
                pred_kps=(detections.get("pred_kps")[i]
                          if detections.get("pred_kps") is not None else None),
            )
            self.writer.add_image(
                f"{tag}/detection_{self._count}", canvas, epoch,
                dataformats="HWC",
            )
            self._count += 1

    def log_stat(self, key: str, value, epoch: int):
        if self.writer is None:
            return
        try:
            value = float(value)
        except (TypeError, ValueError):
            return
        if not np.isfinite(value):
            return  # per-class COCO metrics are NaN for absent classes
        self.writer.add_scalar(key, value, epoch)

    def log_image(self, key: str, image: np.ndarray, epoch: int):
        if self.writer is None:
            return
        self.writer.add_image(key, image, epoch, dataformats="HWC")

    def reset(self):
        self._count = 0
