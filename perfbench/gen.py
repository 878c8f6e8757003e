"""The one traffic generator: batches and images from a mix's parameters
and the seed.

A mix (``perfbench/mixes/<mix>.json``) gives ``input_size``, ``batch``
(``"recipe"``: the configuration's ``batch_size``), ``cycle`` (how many
distinct batches the run turns over), ``objects`` ([least, most] boxes an
image, drawn uniformly), ``box_px`` ([least, most] side of a box in input
pixels) and ``pinned`` (the host tensors in page-locked memory, as the
port's loader hands them over). Images are standard normal pixels (the
normalised input), drawn on the device from the seed in one call and
copied to the host; the targets are encoded as the port's data pipeline
encodes them (a copy of ``ops/gaussian.py``'s arithmetic: CornerNet's
gaussian radius, the max-composited gaussian, ``wh``, ``reg``, ``ind``,
``reg_mask``, and for eval the host keys ``gt_dets``, ``gt_areas`` and
``id``). A UDA configuration's batches carry ``target_domain_input``, as
many images as the source. Every seed gives the same sizes and counts of
work; only the values differ.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

DOWN_RATIO = 4


def gaussian_radius(height: float, width: float,
                    min_overlap: float = 0.7) -> float:
    a1, b1 = 1.0, height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + math.sqrt(max(b1 ** 2 - 4 * a1 * c1, 0.0))) / 2.0
    a2, b2 = 4.0, 2.0 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + math.sqrt(max(b2 ** 2 - 4 * a2 * c2, 0.0))) / 2.0
    a3, b3 = 4.0 * min_overlap, -2.0 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + math.sqrt(max(b3 ** 2 - 4 * a3 * c3, 0.0))) / 2.0
    return min(r1, r2, r3)


def draw_gaussian(heatmap: np.ndarray, cx: int, cy: int, radius: int) -> None:
    d = 2 * radius + 1
    sigma = d / 6
    m = (d - 1.0) / 2.0
    y, x = np.ogrid[-m:m + 1, -m:m + 1]
    g = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    g[g < np.finfo(g.dtype).eps * g.max()] = 0
    h, w = heatmap.shape
    left, right = min(cx, radius), min(w - cx, radius + 1)
    top, bottom = min(cy, radius), min(h - cy, radius + 1)
    hm = heatmap[cy - top:cy + bottom, cx - left:cx + right]
    gg = g[radius - top:radius + bottom, radius - left:radius + right]
    if min(gg.shape) > 0 and min(hm.shape) > 0:
        np.maximum(hm, gg, out=hm)


def encode(boxes: np.ndarray, classes: np.ndarray, out: int,
           num_classes: int, k_max: int) -> Dict[str, np.ndarray]:
    """Targets of one image from its boxes (N, 4) in output-map pixels."""
    t = {"hm": np.zeros((num_classes, out, out), np.float32),
         "wh": np.zeros((k_max, 2), np.float32),
         "reg": np.zeros((k_max, 2), np.float32),
         "ind": np.zeros((k_max,), np.int64),
         "reg_mask": np.zeros((k_max,), np.uint8),
         "gt_dets": np.zeros((k_max, 6), np.float32),
         "gt_areas": np.zeros((k_max,), np.float32)}
    for k, (box, cls) in enumerate(zip(boxes[:k_max], classes)):
        b = np.array(box, np.float32)
        b[[0, 2]] = np.clip(b[[0, 2]], 0, out - 1)
        b[[1, 3]] = np.clip(b[[1, 3]], 0, out - 1)
        h, w = b[3] - b[1], b[2] - b[0]
        if h <= 0 or w <= 0:
            continue
        radius = max(0, int(gaussian_radius(float(np.ceil(h)),
                                            float(np.ceil(w)))))
        ct = np.array([(b[0] + b[2]) / 2, (b[1] + b[3]) / 2], np.float32)
        ci = ct.astype(np.int32)
        draw_gaussian(t["hm"][int(cls)], int(ci[0]), int(ci[1]), radius)
        t["wh"][k] = w, h
        t["ind"][k] = ci[1] * out + ci[0]
        t["reg"][k] = ct - ci
        t["reg_mask"][k] = 1
        t["gt_dets"][k] = (ct[0] - w / 2, ct[1] - h / 2, ct[0] + w / 2,
                           ct[1] + h / 2, 1, int(cls))
        t["gt_areas"][k] = w * h
    return t


def batch_size(mix: dict, recipe_batch: int) -> int:
    b = mix.get("batch", "recipe")
    return int(recipe_batch) if b == "recipe" else int(b)


def images(seed: int, stream: int, count: int, size: int,
           device) -> torch.Tensor:
    """``count`` standard normal images (count, 3, size, size) on
    ``device``, from the seed's stream ``stream``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return torch.randn(count, 3, size, size, generator=gen,
                       device=torch.device(device))


def batches(mix: dict, seed: int, recipe_batch: int, num_classes: int,
            max_detections: int, target_domain: bool, device
            ) -> List[Dict[str, object]]:
    """The mix's cycle of batches on the host, keyed as the port's loader
    keys them."""
    size = int(mix["input_size"])
    out = size // DOWN_RATIO
    b = batch_size(mix, recipe_batch)
    n = int(mix["cycle"])
    pin = bool(mix.get("pinned", True)) and torch.device(device).type == "cuda"
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    imgs = images(seed, 1, n * b, size, device).cpu()
    tgts = images(seed, 2, n * b, size, device).cpu() if target_domain else None
    lo, hi = mix["objects"]
    side_lo, side_hi = mix["box_px"]
    cycle = []
    for i in range(n):
        per = []
        for j in range(b):
            count = int(rng.integers(lo, hi + 1))
            wh = rng.uniform(side_lo, side_hi, (count, 2))
            ctr = rng.uniform(0, size, (count, 2))
            boxes = np.concatenate((ctr - wh / 2, ctr + wh / 2), 1)
            classes = rng.integers(0, num_classes, count)
            per.append(encode(boxes / DOWN_RATIO, classes, out, num_classes,
                              max_detections))
        batch: Dict[str, object] = {
            "input": imgs[i * b:(i + 1) * b].contiguous()}
        for key in ("hm", "wh", "reg", "ind", "reg_mask"):
            batch[key] = torch.from_numpy(np.stack([p[key] for p in per]))
        if target_domain:
            batch["target_domain_input"] = tgts[i * b:(i + 1) * b].contiguous()
        if pin:
            batch = {k: v.pin_memory() for k, v in batch.items()}
        batch["gt_dets"] = np.stack([p["gt_dets"] for p in per])
        batch["gt_areas"] = np.stack([p["gt_areas"] for p in per])
        batch["id"] = np.arange(i * b, (i + 1) * b, dtype=np.int64) + 1
        cycle.append(batch)
    return cycle
