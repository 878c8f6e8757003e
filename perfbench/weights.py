"""Weights from the seed, made on the device in a few large calls.

One ``torch.Generator`` on the device, seeded with ``--seed``, draws one
normal vector for every drawn entry of the reference's state-dict spec;
each entry takes its slice, scaled for its kind:

- ``conv``: He normal, std sqrt(2 / fan_in) (a ReLU network keeps its
  scale);
- ``dcn``: the DCN's weight, the same;
- ``offset``: the DCN's offset conv, std ``offset_std`` / sqrt(fan_in)
  (the mix's ``offset_std``): 0.5, the eval and serving mixes', spreads
  offsets about half a pixel, their largest under 6 px, as a trained
  model's; training from a fresh model starts near the reference
  project's zero-initialised offset convs, and Adam's first steps then
  move the offsets by several pixels (``PERF.md``), so the train mix
  starts small;
- ``head_out``: a head's last 1x1 conv, std 1 / sqrt(fan_in);
- ``bn_weight`` 1 + 0.1 N, ``bn_bias`` 0.1 N;
- fixed: ``zero``, ``one``, ``count`` (0), ``hm_bias`` (-2.19, the
  heatmap prior), ``bilinear<f>`` (the upsampling's bilinear kernel).

``calibrate`` replaces BatchNorm's running statistics, for the cells that
run in eval mode, by the batch statistics of a seeded calibration batch
through the reference, so eval-mode activations keep their scale.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from perfbench.reference.model import HM_BIAS, Net, Spec


def _bilinear(shape, factor: int) -> torch.Tensor:
    k = 2 * factor
    f = math.ceil(k / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    i = torch.arange(k, dtype=torch.float64)
    row = 1 - (i / f - c).abs()
    return (row[:, None] * row[None, :]).float().expand(shape).clone()


def make(spec: Spec, seed: int, device, offset_std: float = 0.5
         ) -> Dict[str, torch.Tensor]:
    """The seed's weights for ``spec`` on ``device``; ``offset_std`` is the
    offset convs' std times sqrt(fan_in) (the mix's ``offset_std``)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    drawn = [(n, s, k) for n, s, k in spec
             if k in ("conv", "dcn", "offset", "head_out", "bn_weight",
                      "bn_bias")]
    total = sum(math.prod(s) for _, s, _ in drawn)
    noise = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, kind in drawn:
        n = math.prod(shape)
        z = noise[at:at + n].view(shape)
        at += n
        if kind in ("conv", "dcn"):
            out[name] = z * math.sqrt(2.0 / math.prod(shape[1:]))
        elif kind == "offset":
            out[name] = z * offset_std * math.sqrt(1.0 / math.prod(shape[1:]))
        elif kind == "head_out":
            out[name] = z * math.sqrt(1.0 / math.prod(shape[1:]))
        elif kind == "bn_weight":
            out[name] = 1.0 + 0.1 * z
        else:
            out[name] = 0.1 * z
    for name, shape, kind in spec:
        if name in out:
            continue
        if kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "one":
            out[name] = torch.ones(shape, device=device)
        elif kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
        elif kind == "hm_bias":
            out[name] = torch.full(shape, HM_BIAS, device=device)
        elif kind.startswith("bilinear"):
            out[name] = _bilinear(shape, int(kind[8:])).to(device)
        else:
            raise ValueError(f"unknown weight kind {kind!r} of {name}")
    return {name: out[name] for name, _, _ in spec}


@torch.no_grad()
def calibrate(net: Net, weights: Dict[str, torch.Tensor],
              images: torch.Tensor) -> None:
    """Set every BatchNorm's running mean and variance to its batch
    statistics on ``images``, through the reference in float32."""
    net.stats = {}
    net.forward(weights, images, mode="calib")
    for p, (mean, var) in net.stats.items():
        weights[f"{p}.running_mean"].copy_(mean)
        weights[f"{p}.running_var"].copy_(var)
    net.stats = {}
