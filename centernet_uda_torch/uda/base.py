"""Baseline (no-UDA) trainer and the base of the UDA trainers.

Counterpart of ``centernet_uda_tpu/uda/base.py`` (the reference's
``uda/base.py``) with the lifecycle hooks the CLI drives: ``init_done``,
``step``, ``epoch_end``, ``get_detections``, ``save_model`` and
``load_model`` (the JAX package's ``epoch_start`` and ``set_phase`` do
nothing a caller reads, and are left out). The train step is forward,
``DetectionLoss``, ``backward()`` and one optimizer step on train-mode
BatchNorm; the eval step runs under ``no_grad`` with eval-mode BatchNorm.
A UDA trainer overrides ``loss_terms`` and sets ``requires_target_domain``;
its two forwards (source, then target) each update BatchNorm's running
statistics, in that order, as the JAX package threads ``batch_stats``
through them, and one backward of the summed loss gives the reference's
two backwards' gradient.

``freeze_base``: a backend built with it has its trunk's parameters
(``base.*``) set to ``requires_grad=False``, and the optimizer takes only
the parameters that require a gradient, as the reference does
(``train.py:89``, ``backends/resnet.py:32-34``): the trunk gets no update,
no weight decay and no moments, while its BatchNorm statistics still move
in train mode. (The JAX package zeroes the trunk's gradient before the
optimizer, so a non-zero weight decay still moves it there.)

Stochastic depth (EfficientNet): the trainer holds a ``torch.Generator`` on
its device and reseeds it before each train step from ``seed + 7919`` and
the step count, as the JAX package folds the step into its dropout key;
a backend that has a ``drop_generator`` attribute draws its masks from it
in train mode. The masks' bits differ from JAX's; every rank draws the same
ones. A graphed train step has the generator registered with its graph,
which reads the reseeded state at every replay, so a replayed step draws
the eager step's masks at the same step count.

Data parallelism (``parallel/ddp.py``): each rank's loss is its share of
the global batch's, the step sums the gradients over the ranks before the
optimizer steps, and ``step`` returns the stats reduced over the ranks (the
global batch's losses, the largest max |dy|). The reduction runs after the
step, on the copies it returns, not inside its graph: it is one all-reduce
of a few scalars, the eager path and the eval step share it, and its result
is read on the host anyway (the meters, the degrade).

Compiled steps (``utils/graphs.py``), the counterpart of the JAX package's
jitted step functions: on the card, ``train_step``, ``eval_step`` and
``decode`` run as CUDA graphs, captured on the second call of an input
signature (the first runs eagerly) and replayed from then on; what they
return are copies, valid however long the caller keeps them. The graphs are
dropped where the JAX package rebuilds its step functions or a captured
constant changes: ``maybe_degrade_dcn``, a learning-rate change in
``epoch_end``, ``load_model``. ``graphs=False`` gives the eager step, and the
CPU always runs eagerly; on the card every step is graphed, the train step
under a process group (its collectives captured, as the JAX package's
sharded step holds XLA's all-reduces) and EfficientNet's (its generator
registered) too. Under a process group every rank drops its graphs at the
same call, so the ranks' collectives stay in step: the degrade is decided
from ``dcn_max_abs_dy``, the maximum over the ranks, every rank follows one
schedule, and every rank loads the checkpoint.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from centernet_uda_torch import resolve_device
from centernet_uda_torch.ops.dcn import DCN, PALLAS_MAX_SHIFT
from centernet_uda_torch.ops.decode import decode_detections
from centernet_uda_torch.parallel import ddp
from centernet_uda_torch.utils import checkpoint as ckpt
from centernet_uda_torch.utils import optim as optim_util
from centernet_uda_torch.utils.graphs import StepGraphs
from centernet_uda_torch.utils.spans import span

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

    def __init__(self, device="cuda", graphs: bool = True):
        self.device = resolve_device(device)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.base_lr: float = 0.0
        self.epoch: int = 0
        self.global_step: int = 0
        self.drop_generator: Optional[torch.Generator] = None
        self.step_graphs: Optional[StepGraphs] = (
            StepGraphs(self.device) if graphs and self.device.type == "cuda"
            else None)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def init_done(self):
        net = self.backend.module.to(self.device)
        opt_name, opt_params = self._optimizer_config()
        self.base_lr = float(opt_params.get("lr", 1e-3))
        self.optimizer = optim_util.make_optimizer(
            opt_name, opt_params,
            [p for p in net.parameters() if p.requires_grad])
        if hasattr(net, "drop_generator"):
            self.drop_generator = torch.Generator(
                next(net.parameters()).device)
            net.drop_generator = self.drop_generator
        n_params = sum(p.numel() for p in net.parameters())
        log.info("initialized %s: %.2fM params on %s", self.backend.name,
                 n_params / 1e6, self.device)

    @property
    def train_generators(self) -> Tuple[torch.Generator, ...]:
        """The generators a train step draws from besides the device's
        default one (a graph registers them)."""
        return () if self.drop_generator is None else (self.drop_generator,)

    def _seed_drop_generator(self) -> None:
        """Reseed the stochastic-depth generator from the seed and the step
        count, so a step's masks do not depend on what ran before it."""
        if self.drop_generator is None:
            return
        seed = int(self.cfg.get("seed", 42)) if self.cfg else 42
        self.drop_generator.manual_seed(
            ((seed + 7919) * 1_000_003 + self.global_step) % (2 ** 63))

    def _optimizer_config(self) -> Tuple[str, Dict[str, Any]]:
        if self.optimizer_cfg is None:
            return "Adam", {"lr": 5e-5}
        return (self.optimizer_cfg.get("name", "Adam"),
                dict(self.optimizer_cfg.get("params", {}) or {}))

    def epoch_end(self):
        """Per-epoch LR schedule step; a new learning rate drops the
        graphs, which hold the old one."""
        self.epoch += 1
        if self.scheduler is not None and self.optimizer is not None:
            if optim_util.set_learning_rate(
                    self.optimizer, self.scheduler.lr(self.epoch,
                                                      self.base_lr)):
                self.invalidate_graphs()

    def invalidate_graphs(self) -> None:
        """Drop the captured steps; the next call of each recaptures."""
        if self.step_graphs is not None:
            self.step_graphs.invalidate()

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
        self.invalidate_graphs()
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

    def _forward_domains(self, source: torch.Tensor, batch, train: bool):
        """The UDA trainers' two forwards: ``source``, then the batch's
        target domain; returns their head dicts."""
        outputs_src = self._apply_backend(source, train)
        outputs_tgt = self._apply_backend(batch["target_domain_input"], train)
        return outputs_src, outputs_tgt

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
        ddp.sum_gradients([self.optimizer])
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

    @staticmethod
    def _batch_tensors(data) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v) for k, v in data.items()
                if isinstance(v, (np.ndarray, torch.Tensor))
                and k not in _HOST_KEYS}

    def _device_batch(self, data) -> Dict[str, torch.Tensor]:
        return {k: v.to(self.device, non_blocking=True)
                for k, v in self._batch_tensors(data).items()}

    def compiled(self, name: str) -> bool:
        """Whether ``name`` (train, eval, decode) runs as a graph: every
        step does on the card, unless the trainer was built with
        ``graphs=False``."""
        return self.step_graphs is not None

    def _run(self, name: str, fn, data, generators=()):
        """``fn`` on the batch's tensors: replayed from its graph where
        ``name`` is compiled (the tensors copied into the graph's static
        inputs; ``generators`` registered with it), else eagerly on the
        tensors moved to the device."""
        if self.compiled(name):
            return self.step_graphs(name, fn, self._batch_tensors(data),
                                    generators)
        return fn(self._device_batch(data))

    #: UDA trainers forward the target domain in every phase
    #: (centernet_uda_tpu/uda/base.py:325-337)
    requires_target_domain = False

    def step(self, data, is_training: bool = True):
        if self.requires_target_domain and "target_domain_input" not in data:
            raise ValueError(
                f"{type(self).__name__} needs a target domain in every "
                "phase; set datasets.<phase>.params.target_domain_glob to a "
                "glob that matches images (the reference configures it for "
                "training, validation and test alike)")
        if is_training:
            if self.drop_generator is not None:
                # the host's reseed of the generator the graph registers
                with span("graphs.reseed"):
                    self._seed_drop_generator()
            stats = self._run("train", self.train_step, data,
                              self.train_generators)
            self.global_step += 1
            return {"stats": ddp.reduce_stats(stats)}
        outputs, stats = self._run("eval", self.eval_step, data)
        outputs = dict(outputs)
        outputs["stats"] = ddp.reduce_stats(stats)
        return outputs

    def decode(self, outputs: Dict[str, torch.Tensor]):
        """Detections of one domain's heads; ``(detections, keypoints)``
        where the heads have ``kps``."""
        heads = {k: outputs[k] for k in ("hm", "wh", "reg", "kps")
                 if outputs.get(k) is not None}
        return self._run("decode", self._decode, heads)

    def _decode(self, heads: Dict[str, torch.Tensor]):
        k = int(self.cfg.get("max_detections", 150)) if self.cfg else 100
        return decode_detections(heads["hm"], heads["wh"], heads.get("reg"),
                                 kps=heads.get("kps"), k=k,
                                 rotated=self.backend.rotated_boxes,
                                 apply_sigmoid=True)

    @torch.no_grad()
    def get_detections(self, outputs, batch) -> Dict[str, Any]:
        """Decode + unpack detections for the evaluator. Rotated rows keep
        the box in columns 0-4 (cx, cy, w, h, angle), score and class in 5
        and 6; the keypoints (predicted and ground truth) come scaled by
        ``down_ratio``."""
        down_ratio = self.backend.down_ratio
        rotated = self.backend.rotated_boxes
        dets = self.decode(outputs["source_domain"])
        has_kps = isinstance(dets, tuple)
        # the host waits here for the eval and decode steps' kernels
        with span("detections.to_host"):
            if has_kps:
                dets, kps = dets
                kps = kps.cpu().numpy() * down_ratio
            dets = dets.cpu().numpy().copy()
        dets[:, :, :4] *= down_ratio

        def host(v):
            return v.cpu().numpy() if isinstance(v, torch.Tensor) else \
                np.asarray(v)

        ids = host(batch["id"])
        mask = host(batch["reg_mask"]) == 1
        dets_gt = host(batch["gt_dets"]).copy()
        areas_gt = host(batch["gt_areas"])
        dets_gt[:, :, :4] *= down_ratio
        if has_kps:
            kps_gt = host(batch["gt_kps"]) * down_ratio
        box_idx, cls_idx = (5, 6) if rotated else (4, 5)
        gt_boxes, gt_clss, gt_ids, gt_areas, gt_kps = [], [], [], [], []
        for i in range(dets_gt.shape[0]):
            det_gt = dets_gt[i, mask[i]]
            gt_boxes.append(det_gt[:, :box_idx])
            gt_clss.append(det_gt[:, cls_idx].astype(np.int32))
            gt_ids.append(ids[i])
            gt_areas.append(areas_gt[i, mask[i]])
            if has_kps:
                gt_kps.append(kps_gt[i, mask[i]])
        out = {
            "pred_boxes": dets[:, :, :box_idx],
            "pred_classes": dets[:, :, cls_idx].astype(np.int32),
            "pred_scores": dets[:, :, box_idx],
            "gt_boxes": gt_boxes,
            "gt_classes": gt_clss,
            "gt_ids": gt_ids,
            "gt_areas": gt_areas,
        }
        if has_kps:
            out["gt_kps"] = gt_kps
            out["pred_kps"] = kps
        return out

    # ------------------------------------------------------------------
    # checkpointing (utils/helper.py:83-147 semantics)
    # ------------------------------------------------------------------
    def load_model(self, path, resume: bool = False) -> int:
        """Restore weights (and, with ``resume``, the optimizer and the
        epoch); returns the first epoch to run. Drops the graphs: a resume
        replaces the optimizer's state tensors."""
        epoch = ckpt.load_checkpoint(path, self.backend.module,
                                     self.optimizer, resume=resume,
                                     backend_name=self.backend.name)
        self.invalidate_graphs()
        self.epoch = epoch
        return epoch + 1

    def save_model(self, path, epoch: int, with_optimizer: bool = False):
        ckpt.save_checkpoint(path, self.backend.module, epoch,
                             self.optimizer if with_optimizer else None)
