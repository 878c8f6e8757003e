"""Model FLOPs of one image's forward: the port's models against the JAX
model's and against the benchmark's count.

The port's side is counted here (``flop_counts``) with
``torch.utils.flop_counter.FlopCounterMode`` on the ``meta`` device
(shapes only, no arithmetic and no memory): convolutions (transposed ones
at their input positions), matrix products, each multiply-add as 2
FLOPs. The DCN layers run the exact op (``dcn_impl="xla"``), whose
contraction is a visible ``bmm`` and whose offset conv is a convolution.
Bilinear sampling, BatchNorm, activations and decode are not counted.

The JAX side counts the forward of DLA-34 (6 classes, one image) on its
exact DCN path by a walk of the forward's jaxpr written here, which enters
every sub-jaxpr: those under a ``.jaxpr`` attribute (``pjit``,
``custom_vjp``) and the bare ``Jaxpr`` of ``remat`` (``checkpoint``),
where the DCN layers run. ``tools/flops_count.py`` (its numbers behind
``bench.py``'s 57.2 GFLOP/img) enters only the former, so it misses every
DCN contraction.

What must agree exactly, at 64 and 128 px:

- the DCN contraction: the port's ``bmm`` against JAX's ``dot_general``
  (0.887e9 at 128 px);
- every convolution that both models compute alike: the DCN layers'
  offset convs, the trunk's trees, roots and projections, the heads' 3x3
  convs.

What differs, by the TPU-only rewrites of the JAX model (term by term;
``S`` the input size):

- the space-to-depth stem (``centernet_uda_tpu/models/dla.py:_S2DConv``):
  the 7x7 base conv (3 -> 16 at S) is a 5x5 conv of 12 -> 64 channels at
  S/2, level 0's 3x3 (16 -> 16 at S) a 3x3 of 64 -> 64 at S/2, level 1's
  stride-2 3x3 (16 -> 32) a 2x2 of 64 -> 32 at S/2;
- the merged heads (``common.apply_merged_heads``): the three 1x1 output
  convs are one block-diagonal conv of 3 * 256 inputs, so each output
  channel counts 3 times the inputs it reads;
- the upsampling (``DepthwiseUp``): an lhs-dilated depthwise conv counts
  every position of its dilated input, zeros included, f^2 times the
  multiplications of the port's transposed conv, which counts its input
  positions.

The benchmark's ``mfu.*`` divides by ``perfbench/counts.forward_flops`` on
the configuration's plain reference net (``perfbench/reference/``), not on
the port's model: for every configuration of ``perfbench/configs/`` the
two counts must be equal, the port's model composed as the benchmark
composes it (the configuration's ``experiment`` and ``overrides``).
"""

import json
import sys
from pathlib import Path

import pytest

import jax
import jax.numpy as jnp
from jax.extend import core as jcore
import torch
from torch.utils.flop_counter import FlopCounterMode

from centernet_uda_torch import models
from centernet_uda_torch.config import compose

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SIZES = (64, 128)
HEADS = ("hm", "wh", "reg")
HEAD_CONV = 256
# the stem layers: port module -> JAX name, and (kernel, cin, cout, stride)
# of the plain layer
STEM = {
    "base.base_layer.0": ("base/base_conv", (7, 3, 16, 1)),
    "base.level0.0": ("base/level0_conv0", (3, 16, 16, 1)),
    "base.level1.0": ("base/level1_conv0", (3, 16, 32, 2)),
}
# their space-to-depth forms: (kernel, cin, cout) on the S/2 grid
S2D_STEM = {"base/base_conv": (5, 12, 64), "base/level0_conv0": (3, 64, 64),
            "base/level1_conv0": (2, 64, 32)}


def flop_counts(backend_name, size, **backend_params):
    """FLOPs of one ``size`` x ``size`` image's forward of the port's
    backend built with ``backend_params`` on the exact DCN op, in float32,
    by module and op: ``{"Global": {op: flops}, "<Module>.<path>": {...}}``,
    the op names as strings (e.g. ``"aten.convolution"``)."""
    params = {**backend_params, "dcn_impl": "xla", "dtype": torch.float32,
              "device": "meta"}
    net = models.build(backend_name, **params).module.eval()
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        net(torch.zeros(1, 3, size, size, device="meta"))
    return {module: {str(op): int(n) for op, n in ops.items()}
            for module, ops in counter.get_flop_counts().items()}


def forward_flops(backend_name, size, **backend_params):
    return sum(flop_counts(backend_name, size,
                           **backend_params)["Global"].values())


def _conv_flops(eqn):
    out = eqn.outvars[0].aval
    rhs = eqn.invars[1].aval
    spec = eqn.params["dimension_numbers"].rhs_spec
    k = rhs.shape[spec[1]]
    for d in spec[2:]:
        k *= rhs.shape[d]
    return 2 * out.size * k


def _dot_flops(eqn):
    lhs = eqn.invars[0].aval
    k = 1
    for d in eqn.params["dimension_numbers"][0][0]:
        k *= lhs.shape[d]
    return 2 * eqn.outvars[0].aval.size * k


def walk(jaxpr, convs, dots):
    """Every conv of ``jaxpr`` and its sub-jaxprs into ``convs`` as (name,
    kernel height, lhs dilation, flops), every ``dot_general``'s flops into
    ``dots``."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            dots.append(_dot_flops(eqn))
        elif eqn.primitive.name == "conv_general_dilated":
            name = str(eqn.source_info.name_stack).removeprefix("DLASeg")
            rhs = eqn.invars[1].aval
            convs.append((name.lstrip("/"), rhs.shape[0],
                          eqn.params["lhs_dilation"][0], _conv_flops(eqn)))
        for value in eqn.params.values():
            for sub in (value if isinstance(value, (list, tuple))
                        else [value]):
                if isinstance(sub, jcore.ClosedJaxpr):
                    walk(sub.jaxpr, convs, dots)
                elif isinstance(sub, jcore.Jaxpr):
                    walk(sub, convs, dots)


_CACHE = {}


def jax_counts(size):
    """(jaxpr, convs, dot flops) of the JAX DLA-34's forward at ``size``,
    on its XLA DCN path, traced from abstract shapes."""
    if size not in _CACHE:
        from centernet_uda_tpu import models
        from centernet_uda_tpu.ops import dcn as dcn_ops

        previous = dcn_ops.get_pallas_default()
        dcn_ops.set_pallas_default(False)
        try:
            module = models.build("dla", num_classes=6).module
            x = jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)
            variables = jax.eval_shape(
                lambda k, xx: module.init(k, xx, train=False),
                jax.random.PRNGKey(0), x)
            jaxpr = jax.make_jaxpr(
                lambda v, xx: module.apply(v, xx, train=False))(variables, x)
        finally:
            dcn_ops.set_pallas_default(previous)
        convs, dots = [], []
        walk(jaxpr.jaxpr, convs, dots)
        _CACHE[size] = (jaxpr, convs, sum(dots))
    return _CACHE[size]


def port_convs(size):
    """The port's conv FLOPs by leaf module (the ``DLASeg.`` prefix
    dropped) and its ``bmm`` FLOPs."""
    counts = flop_counts("dla", size, num_classes=6)
    leaves = {m: ops for m, ops in counts.items()
              if m != "Global" and not any(o.startswith(m + ".")
                                           for o in counts)}
    convs = {m.removeprefix("DLASeg."): ops["aten.convolution"]
             for m, ops in leaves.items() if "aten.convolution" in ops}
    return convs, counts["Global"].get("aten.bmm", 0), counts["Global"]


def jax_name(port_name):
    if port_name in STEM:
        return STEM[port_name][0]
    return (port_name.replace(".", "/")
            .replace("/project/0", "/project_conv")
            .replace("/conv/conv_offset_mask", "/conv"))


def plain_conv(size, kernel, cin, cout, stride):
    return 2 * (size // stride) ** 2 * cout * kernel * kernel * cin


@pytest.mark.parametrize("size", SIZES)
def test_dcn_contraction_equals_jax_exactly(size):
    _, _, jax_dots = jax_counts(size)
    _, bmm, total = port_convs(size)
    assert set(total) == {"aten.convolution", "aten.bmm"}
    assert bmm == jax_dots
    if size == 128:
        assert bmm == 887_095_296


@pytest.mark.parametrize("size", SIZES)
def test_convolutions_match_jax_but_for_the_tpu_rewrites(size):
    _, jconvs, _ = jax_counts(size)
    convs, _, _ = port_convs(size)
    by_name = {}
    for name, kernel, dilation, n in jconvs:
        by_name.setdefault(name, []).append((kernel, dilation, n))
    # the merged heads: one 3x3 and one 1x1 conv at the model's root
    heads = sorted(by_name.pop(""))
    assert [k for k, _, _ in heads] == [1, 3]
    assert heads[1][2] == sum(convs[f"{h}.0"] for h in HEADS)
    assert heads[0][2] == len(HEADS) * sum(convs[f"{h}.2"] for h in HEADS)

    gaps = {"stem": 0, "heads": heads[0][2] - sum(
        convs[f"{h}.2"] for h in HEADS), "upsampling": 0}
    n_offset = 0
    for name, n in convs.items():
        if name.split(".")[0] in HEADS:
            continue
        (kernel, dilation, n_jax), = by_name.pop(jax_name(name))
        if name in STEM:
            k, cin, cout, stride = STEM[name][1]
            assert n == plain_conv(size, k, cin, cout, stride)
            sk, scin, scout = S2D_STEM[jax_name(name)]
            assert kernel == sk
            assert n_jax == plain_conv(size // 2, sk, scin, scout, 1)
            gaps["stem"] += n_jax - n
        elif ".up_" in name:
            assert n_jax == dilation ** 2 * n
            gaps["upsampling"] += n_jax - n
        else:
            n_offset += name.endswith("conv_offset_mask")
            assert n_jax == n, name
    assert not by_name  # every JAX conv has its port layer
    assert n_offset == 16  # the DCN layers' offset convs

    jax_total = sum(n for *_, n in jconvs)
    port_total = sum(convs.values())
    assert jax_total - port_total == sum(gaps.values())
    if size == 128:
        assert (port_total, jax_total) == (3_211_575_296, 3_574_251_520)
        assert gaps == {"stem": 336_068_608, "heads": 10_485_760,
                        "upsampling": 16_121_856}


@pytest.mark.parametrize("size", SIZES)
def test_jax_tool_leaves_out_the_dcn_contraction(size):
    """``tools/flops_count.count_forward_flops`` (bench.py's 57.2 GFLOP/img
    at 512 px) is the full walk less every DCN contraction."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from flops_count import count_forward_flops

    jaxpr, jconvs, jax_dots = jax_counts(size)
    full = sum(n for *_, n in jconvs) + jax_dots
    assert jax_dots > 0
    assert count_forward_flops(jaxpr.jaxpr) == full - jax_dots


def test_count_scales_with_the_area():
    """Every map of DLA-34 halves exactly from 64 px on, so the count is
    the 64 px count times the area ratio: 4x at 128 px, 64x at 512 px."""
    at64 = forward_flops("dla", 64, num_classes=6)
    assert forward_flops("dla", 128, num_classes=6) == 4 * at64
    assert forward_flops("dla", 512, num_classes=6) == 64 * at64
    assert 64 * at64 == 65_578_729_472


# the benchmark's configurations and their counts at 64 and 512 px
BENCHMARK_CONFIGS = sorted((ROOT / "perfbench" / "configs").glob("*.json"))
BENCHMARK_FLOPS = {
    ("dla34_baseline", 64): 1_024_667_648,
    ("dla34_baseline", 512): 65_578_729_472,
    ("dla34_entmin", 64): 1_024_667_648,
    ("dla34_entmin", 512): 65_578_729_472,
    ("b3_coco_merged", 64): 1_591_844_608,
    ("b3_coco_merged", 512): 101_643_739_264,
}


@pytest.mark.parametrize("size", (64, 512))
@pytest.mark.parametrize("path", BENCHMARK_CONFIGS, ids=lambda p: p.stem)
def test_benchmark_counts_the_programs_model(path, size):
    """The count the benchmark's ``mfu.*`` divides by, on the
    configuration's reference net, equals the count of the port's backend
    as the configuration composes it."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from perfbench import check, counts

    cfg = json.loads(path.read_text())
    program = compose([f"experiment={cfg['experiment']}",
                       *cfg["overrides"]],
                      config_dir=str(ROOT / "configs"))
    want = forward_flops(program.model.backend.name, size,
                         **program.model.backend.params.to_dict())
    got = counts.forward_flops(check.make_net(cfg["reference"]), size)
    assert got == want == BENCHMARK_FLOPS[cfg["name"], size]
