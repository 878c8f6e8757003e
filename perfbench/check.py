"""What decides ``correct``: the program's answers against the reference's.

Run after the window has closed and the program's state is freed. Every
number compared is a gap between the program and the reference, and each
has a limit of its own in ``perfbench/limits/<workload>.json``; a run is
correct where every number is finite and within its limit.

Training (three steps of the window's own call, on three distinct
batches, from the benchmark's weights: on the card each a replay of the
captured step that the window replays, after set-up has captured it and
put the trainer's state back to the seed's):

- ``loss``: the largest relative gap of a loss term (``hm_loss``,
  ``wh_loss``, ``off_loss``, with entropy minimization ``entropy_loss``,
  and ``total_loss``) of the first step (``loss_steps``, over all three,
  is read but not judged: Adam's first update is the gradient's sign, so
  the later steps carry the sign noise of near-zero gradients);
- ``grad_norm``: the worst leaf's gap between the norms of the first
  gradient as the optimizer took it (the program's from Adam's first moment
  after one step, ``exp_avg / (1 - beta1)``), over the larger of that
  leaf's and the median leaf's reference norm;
- ``change_norm``: the same for the parameters' change over the three
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (biases before a BatchNorm: Adam moves
  them by round-off alone);
- ``bn_stats``: the worst BatchNorm layer's gap of its running statistics
  after the first step, over their change in it.

Eval and serving (a sample of the window's answers, drawn from the seed):

- ``heads`` (eval): the largest gap of a head's map over that head's
  largest magnitude in the reference;
- ``box_gap``: for each detection, the distance (largest coordinate gap,
  input pixels; of a rotated box the center and size) to the nearest box
  the reference predicts at any position of the map; the largest over all
  detections;
- ``angle_gap`` (rotated boxes): at that position, the gap between the
  detection's angle and the reference's, in degrees, wrapped to the
  shorter way round; the largest;
- ``kps_gap`` (a ``kps`` head): at that position, the largest coordinate
  gap between the detection's keypoints and the reference's, in input
  pixels; the largest;
- ``det_score_gap``: at that position, the gap between the detection's
  score and the reference's score of the detection's class; the largest;
- ``peak_cover``: which k the decode selected. For each of the
  reference's k highest 3x3 peaks, the smaller of two margins: its score
  over the reference's k-th, and its score over the best reference score
  at a detection of its class within ``PEAK_REACH`` map cells each way
  (the detection's position being that of its nearest reference box, as
  above); the largest over the peaks. A peak found by the program reads 0
  or less, one that trades places with the k-th across rounding reads a
  rounding-sized margin, and so does one on a flat top whose maximum the
  program's rounding moves a few cells (the reach is for that: 3x3
  peaks on such tops move further than one cell under rounding); a
  decode without peak suppression, or one that selects other positions,
  leaves peaks far above the k-th uncovered.

Read beside them and not judged (``PERF.md`` gives the readings: the
control does not read three times the program in them): the eval loss
terms' largest relative gap (``loss``), and ``score_gap``, the largest gap
between an image's k scores, sorted, and the reference's k highest peaks.
"""

from __future__ import annotations

import importlib.util
import math
import sys
from contextlib import contextmanager
from pathlib import Path
from statistics import median
from typing import Dict, List, Optional, Sequence

import torch

from perfbench import weights as weights_lib
from perfbench.reference import train as rtrain

NETS = Path(__file__).resolve().parent / "reference"
NOT_NETS = ("__init__", "train")  # reference/ modules that are no net

BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")
EVAL_ROWS = 4
PEAK_REACH = 8  # map cells each way within which a detection covers a peak


@contextmanager
def tf32(on: bool):
    """TF32 in matmuls and cuDNN convolutions while inside (the control's
    precision); float32 otherwise."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def nets() -> List[str]:
    """The reference nets on disk: ``perfbench/reference/<net>.py``."""
    return sorted(p.stem for p in NETS.glob("*.py")
                  if p.stem not in NOT_NETS)


def make_net(ref: dict):
    """The reference net that the configuration's ``reference.net`` names,
    built from ``ref`` by its module's ``build``; its ``kinds`` are the
    module's ``KINDS`` (weights of its own kinds, for ``weights.make``)."""
    name = ref.get("net")
    if name not in nets():
        raise ValueError(f"reference.net {name!r} names no file "
                         f"perfbench/reference/<net>.py; the nets on disk: "
                         f"{nets()}")
    key = f"perfbench.reference.{name}"
    module = sys.modules.get(key)
    if module is None:
        spec_ = importlib.util.spec_from_file_location(key,
                                                       NETS / f"{name}.py")
        module = importlib.util.module_from_spec(spec_)
        spec_.loader.exec_module(module)
        sys.modules[key] = module
    net = module.build(ref)
    net.kinds = dict(getattr(module, "KINDS", {}))
    return net


def is_leaf(name: str) -> bool:
    return not name.endswith(BUFFER_SUFFIXES)


def to_device(batch: dict, device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in batch.items()
            if isinstance(v, torch.Tensor)}


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
def reference_train(ref: dict, spec, seed: int, batches: List[dict],
                    device, control: bool = False, half: bool = False,
                    offset_std: float = 0.5,
                    steps: Optional[Sequence[int]] = None) -> dict:
    """The reference's three steps: per-step loss terms, the first fed
    gradient's norm per leaf and the change's norm per leaf. ``control``
    computes at TF32; ``half`` plants a fault: each step sees the first
    half of its batch alone. ``steps`` are the program's global steps of
    the batches (a net that draws per step draws as the program did)."""
    net = make_net(ref)
    net.checkpoint = True
    w0 = weights_lib.make(spec, seed, device, offset_std, net.kinds)
    names = [n for n, _, _ in spec if is_leaf(n)]
    leaves = [w0[n].clone().requires_grad_(True) for n in names]
    opt = rtrain.Adam(leaves, ref["optimizer"]["lr"],
                      ref["optimizer"]["weight_decay"])
    losses, grad_norms, running = [], None, None
    with tf32(control):
        for i, batch in enumerate(batches):
            b = to_device(batch, device)
            if half:
                b = {k: v[:v.shape[0] // 2] for k, v in b.items()}
            P = {**w0, **dict(zip(names, leaves))}
            mode = "calib" if i == 0 else "train"
            step = None if steps is None else steps[i]
            heads = net.forward(P, b["input"], mode, step)
            running = _fold_running(w0, net.stats, running) if i == 0 \
                else running
            loss, terms = rtrain.detection_loss(heads, b, ref["loss"])
            if ref.get("entropy_weight") is not None:
                tgt = net.forward(P, b["target_domain_input"], mode, step)
                if i == 0:
                    running = _fold_running(w0, net.stats, running)
                ent = rtrain.entropy_loss(tgt["hm"])
                loss = loss + ent * ref["entropy_weight"]
                terms["entropy_loss"] = ent
            terms["total_loss"] = loss
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            fed = opt.step(list(grads))
            losses.append({k: float(v.detach()) for k, v in terms.items()})
            if i == 0:
                grad_norms = {n: 0.0 if g is None else float(g.double().norm())
                              for n, g in zip(names, fed)}
            del heads, loss, terms, grads, fed, P
    change = {n: float((p.detach().double() - w0[n].double()).norm())
              for n, p in zip(names, leaves)}
    net.stats = {}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "running": running}


def _fold_running(w0, stats, running, momentum: float = 0.1):
    """BatchNorm's running statistics after a train-mode forward whose
    batch statistics are ``stats`` (torch's update with the biased
    variance, as the port's BatchNorm makes it)."""
    out = {} if running is None else dict(running)
    for p, (mean, var) in stats.items():
        for name, value in ((f"{p}.running_mean", mean),
                            (f"{p}.running_var", var)):
            old = out.get(name, w0[name].double().cpu())
            out[name] = old + momentum * (value.detach().double().cpu() - old)
    stats.clear()
    return out


def running_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                 init) -> List[float]:
    """Per BatchNorm layer: the gap of its running statistics after the
    first step, over their change from the initial values."""
    gaps = []
    for name in sorted(ref):
        if not name.endswith("running_mean"):
            continue
        p = name[:-len("running_mean")]
        pr = torch.cat([prog[p + s].flatten() for s in ("running_mean",
                                                         "running_var")])
        rf = torch.cat([ref[p + s].flatten() for s in ("running_mean",
                                                       "running_var")])
        i0 = torch.cat([init[p + s].double().cpu().flatten()
                        for s in ("running_mean", "running_var")])
        gaps.append(float((pr - rf).norm() / (rf - i0).norm()
                          .clamp(min=1e-30)))
    return gaps


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
                keep=None) -> float:
    names = [n for n in ref if keep is None or keep(n)]
    mid = median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], mid, 1e-30)
               for n in names)


def _rel(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-30)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    p, r = prog["losses"][0], ref["losses"][0]
    grads = ref["grad_norms"]
    mid = median(grads.values())
    init = {n: (torch.zeros_like(t) if n.endswith("mean")
                else torch.ones_like(t)) for n, t in ref["running"].items()}
    return {
        "loss": max(_rel(p[k], r[k]) for k in r),
        "grad_norm": _worst_leaf(prog["grad_norms"], grads),
        "change_norm": _worst_leaf(prog["change_norms"], ref["change_norms"],
                                   keep=lambda n: grads[n] >= 1e-3 * mid),
        "bn_stats": max(running_gaps(prog["running"], ref["running"], init)),
        "loss_steps": max(_rel(a[k], b[k]) for a, b in zip(prog["losses"],
                                                           ref["losses"])
                          for k in b),
    }


# ----------------------------------------------------------------------
# eval and serving
# ----------------------------------------------------------------------
@torch.no_grad()
def reference_heads(net, weights, images: torch.Tensor,
                    rows: int = EVAL_ROWS) -> Dict[str, torch.Tensor]:
    """Eval-mode heads, computed in blocks of ``rows`` images."""
    parts = [net.forward(weights, images[i:i + rows], "eval")
             for i in range(0, images.shape[0], rows)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _larger(a: float, b: float) -> float:
    """The larger of two gaps, NaN if either is: a NaN answer is never
    within its limit (``max`` keeps its first argument against a NaN)."""
    return a if a != a or a > b else b


@torch.no_grad()
def detection_numbers(dets: dict, heads: Dict[str, torch.Tensor], k: int,
                      down_ratio: int, reach: int = PEAK_REACH
                      ) -> Dict[str, float]:
    """``score_gap``, ``box_gap``, ``det_score_gap`` and ``peak_cover``
    of detections ``dets`` (``boxes`` (B, k, 4) input pixels, or rotated
    (B, k, 5), ``scores``, ``classes`` (B, k), with a ``kps`` head ``kps``
    (B, k, P, 2)) against the reference heads; of rotated boxes also
    ``angle_gap``, with a ``kps`` head also ``kps_gap``."""
    device = heads["hm"].device
    rotated = heads["wh"].shape[1] == 3
    keys = ["score_gap", "box_gap", "det_score_gap", "peak_cover"]
    keys += ["angle_gap"] * rotated + ["kps_gap"] * ("kps" in heads)
    boxes = torch.as_tensor(dets["boxes"], device=device).float()
    scores = torch.as_tensor(dets["scores"], device=device).float()
    classes = torch.as_tensor(dets["classes"], device=device).long()
    top = rtrain.top_detections(heads, k, down_ratio)
    kps = ref_kps = None
    if "kps" in heads and dets.get("kps") is not None:
        kps = torch.as_tensor(dets["kps"], device=device).float()
    if scores.shape != top["scores"].shape or boxes.shape != top[
            "boxes"].shape or classes.shape != top["classes"].shape or (
            "kps" in heads and (kps is None
                                or kps.shape != top["kps"].shape)):
        return dict.fromkeys(keys, math.inf)
    sorted_gap = (scores.sort(1, descending=True).values
                  - top["scores"]).abs()
    heat = rtrain._sigmoid(heads["hm"].float())
    b, c, h, w = heat.shape
    everywhere = torch.arange(h * w, device=device).expand(b, -1)
    # (B, HW, 4), rotated (B, HW, 5)
    ref_boxes = rtrain.boxes_at(heads, everywhere, down_ratio)
    if kps is not None:
        ref_kps = rtrain.keypoints_at(heads, everywhere, down_ratio)
    box_gap = det_gap = cover = angle_gap = kps_gap = 0.0
    for i in range(b):
        dist = (ref_boxes[i][None, :, :4] - boxes[i][:, None, :4]
                ).abs().amax(-1)
        near, at = dist.min(1)  # the reference's nearest box, and where
        ref_score = heat[i].reshape(c, -1)[classes[i], at]
        box_gap = _larger(box_gap, float(near.max()))
        det_gap = _larger(det_gap,
                          float((ref_score - scores[i]).abs().max()))
        if rotated:
            turn = (boxes[i][:, 4] - ref_boxes[i][at, 4]).remainder(360.0)
            angle_gap = _larger(angle_gap, float(
                torch.minimum(turn, 360.0 - turn).max()))
        if kps is not None:
            kps_gap = _larger(kps_gap,
                              float((kps[i] - ref_kps[i][at]).abs().max()))
        peaks = top["positions"][i]
        covers = ((classes[i][None] == top["classes"][i][:, None])
                  & ((at // w)[None] - (peaks // w)[:, None]).abs().le(reach)
                  & ((at % w)[None] - (peaks % w)[:, None]).abs().le(reach))
        best = torch.where(covers, ref_score[None], -1.0).amax(1)
        ps = top["scores"][i]
        cover = _larger(cover,
                        float(torch.minimum(ps - best, ps - ps[-1]).max()))
    out = {"score_gap": float(sorted_gap.max()), "box_gap": box_gap,
           "det_score_gap": det_gap, "peak_cover": cover,
           "angle_gap": angle_gap, "kps_gap": kps_gap}
    return {key: out[key] for key in keys}


def heads_gap(prog: Dict[str, torch.Tensor],
              ref: Dict[str, torch.Tensor]) -> float:
    if any(prog[n].shape != ref[n].shape for n in ref):
        return math.inf
    gap = 0.0
    for n in ref:
        gap = _larger(gap, float(
            (prog[n].to(ref[n].device).float() - ref[n]).abs().max()
            / ref[n].abs().max().clamp(min=1e-30)))
    return gap


def eval_numbers(answers: List[dict], net, weights, cycle: List[dict],
                 ref: dict, device, reach: int = PEAK_REACH
                 ) -> Dict[str, float]:
    """Each sampled eval call (``batch`` index, ``stats``, ``heads``,
    ``dets``) against the reference on its batch."""
    out: Dict[str, float] = {"loss": 0.0, "heads": 0.0}
    done: Dict[int, tuple] = {}
    for a in answers:
        if a["batch"] not in done:
            b = to_device(cycle[a["batch"]], device)
            heads = reference_heads(net, weights, b["input"])
            _, terms = rtrain.detection_loss(heads, b, ref["loss"])
            terms["total_loss"] = sum(terms.values())
            done[a["batch"]] = (heads, {k: float(v)
                                        for k, v in terms.items()})
        heads, terms = done[a["batch"]]
        out["loss"] = max(out["loss"], max(_rel(a["stats"][k], terms[k])
                                           for k in terms))
        out["heads"] = _larger(out["heads"], heads_gap(a["heads"], heads))
        nums = detection_numbers(a["dets"], heads, ref["max_detections"],
                                 ref["down_ratio"], reach)
        for key, v in nums.items():
            out[key] = _larger(out.get(key, 0.0), v)
    return out


def serve_numbers(answers: List[dict], net, weights,
                  images: torch.Tensor, ref: dict, reach: int = PEAK_REACH
                  ) -> Dict[str, float]:
    """Each sampled served call (``image`` index, ``dets``) against the
    reference on its image."""
    out: Dict[str, float] = {}
    done: Dict[int, dict] = {}
    for a in answers:
        i, n = a["image"], a.get("count", 1)
        if i not in done:
            done[i] = reference_heads(net, weights, images[i:i + n])
        nums = detection_numbers(a["dets"], done[i], ref["max_detections"],
                                 ref["down_ratio"], reach)
        for key, v in nums.items():
            out[key] = _larger(out.get(key, 0.0), v)
    return out


# ----------------------------------------------------------------------
# the control: the reference in the program's place, at TF32; faults
# ----------------------------------------------------------------------
def unsuppressed(heads: Dict[str, torch.Tensor], k: int, down_ratio: int
                 ) -> Dict[str, torch.Tensor]:
    """A decode without peak suppression (a fault): the k highest
    positions of the map over all classes, every position a peak."""
    heat = rtrain._sigmoid(heads["hm"].float())
    b, c, h, w = heat.shape
    scores, flat = torch.topk(heat.reshape(b, -1), k)
    pos = flat % (h * w)
    out = {"boxes": rtrain.boxes_at(heads, pos, down_ratio),
           "scores": scores, "classes": flat // (h * w), "positions": pos}
    if "kps" in heads:
        out["kps"] = rtrain.keypoints_at(heads, pos, down_ratio)
    return out


def negated_angle(heads: Dict[str, torch.Tensor], k: int, down_ratio: int
                  ) -> Dict[str, torch.Tensor]:
    """The decode with each rotated box's angle negated (a fault)."""
    top = rtrain.top_detections(heads, k, down_ratio)
    top["boxes"] = torch.cat((top["boxes"][..., :4],
                              -top["boxes"][..., 4:]), -1)
    return top


def zeroed_keypoints(heads: Dict[str, torch.Tensor], k: int,
                     down_ratio: int) -> Dict[str, torch.Tensor]:
    """The decode with the ``kps`` head zeroed (a fault): every keypoint
    at its box's center."""
    return rtrain.top_detections(
        {**heads, "kps": torch.zeros_like(heads["kps"])}, k, down_ratio)


@torch.no_grad()
def control_answer(net, weights, batch: dict, ref: dict, device,
                   serve: bool = False, decode=rtrain.top_detections,
                   control: bool = True) -> dict:
    """The answers of one eval call, or one served image, computed by the
    reference at TF32 (the control); with ``control`` False in float32,
    and with another ``decode`` (``unsuppressed``, ``negated_angle``,
    ``zeroed_keypoints``) the reference put in the program's place with
    that fault planted."""
    b = to_device(batch, device)
    with tf32(control):
        heads = reference_heads(net, weights, b["input"])
        top = decode(heads, ref["max_detections"], ref["down_ratio"])
        if serve:
            return {"dets": top}
        _, terms = rtrain.detection_loss(heads, b, ref["loss"])
    terms["total_loss"] = sum(terms.values())
    return {"stats": {k: float(v) for k, v in terms.items()},
            "heads": heads, "dets": top}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Optional[bool]:
    """True where every number is finite and within its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)
