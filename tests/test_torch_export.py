"""The port's serving export (``centernet_uda_torch/export.py``) on the CPU.

- Serving against JAX: the JAX package's ``make_serving_fn`` and the port's
  ``ServingModule`` on bridged weights (eval-mode BatchNorm with randomised
  statistics), for ResNet-18 at 64 px, a narrow DLA with its DCN neck at
  128 px (the exact DCN op on both sides) and the narrow DLA with rotated
  boxes and 5 keypoints: scores, and boxes, classes and keypoints at the
  top-k entries whose order is untied; the raw heads (``-wd``) too. Both
  compute float32 convolutions in other orders: heads, boxes and keypoints
  within 1e-4 of their scale, scores within 1e-5.
- Round trip: the ``.pt2`` and ``.opt.pt2`` of the narrow DLA on the kernel
  path (``dcn_impl: cuda``, whose CPU implementation is the plain twin)
  hold ``centernet_uda::`` ops and no traced twin, and give the eager
  module's outputs exactly; a fresh process that imports only the port
  loads the artifact with ``load_artifact`` and serves it, with no JAX in
  ``sys.modules`` and TF32 off.
- CLI: ``python -m centernet_uda_torch.export`` on the run directory of a
  1-epoch ``train.main`` on the CPU.
"""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_uda_tpu import models as jax_models
from centernet_uda_tpu.export import make_serving_fn
from centernet_uda_tpu.models import common as jax_common
from centernet_uda_tpu.models.dla import DLASeg as JaxDLASeg
from centernet_uda_tpu.ops import dcn as jax_dcn
from centernet_uda_torch import export, models, train
from centernet_uda_torch.models.common import make_heads_dict
from centernet_uda_torch.utils.weights import state_dict_from_jax
from tests.util_fixtures import make_tiny_coco

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
NARROW = dict(levels=(1, 1, 1, 1, 1, 1), channels=(4, 8, 8, 16, 16, 32),
              head_conv=8)
K = 10


@pytest.fixture(scope="module", autouse=True)
def jax_exact_dcn():
    old = jax_dcn.get_pallas_default(), jax_common.get_bn_groups()
    jax_dcn.set_pallas_default(False)
    jax_common.set_bn_groups(1)
    yield
    jax_dcn.set_pallas_default(old[0])
    jax_common.set_bn_groups(old[1])


def randomise_stats(variables, seed):
    """Eval-mode BatchNorm statistics away from (0, 1), nonzero offset
    convs so the deformable sampling is exercised, and the heatmap head's
    kernels scaled up so the top-k scores stand apart."""
    rng = np.random.RandomState(seed)

    def perturb(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        leaf = np.asarray(leaf)
        if names[-1] == "mean":
            return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)
        if names[-1] == "var":
            return (rng.rand(*leaf.shape) + 0.5).astype(np.float32)
        if "conv_offset_mask" in names:
            return (rng.randn(*leaf.shape) * 0.05).astype(np.float32)
        if names[-1] == "kernel" and any(n.startswith("hm_")
                                         for n in names):
            return leaf * 8.0
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, variables)


def jax_and_port(kind, size, rotated=False, kps=0):
    """(JAX backend, its state, the port's backend on bridged weights)."""
    if kind == "resnet":
        backend = jax_models.build("resnet", num_layers=18, num_classes=3,
                                   pretrained=False)
        variables = backend.init(jax.random.PRNGKey(0), (size, size))
        port = models.build("resnet", num_layers=18, num_classes=3,
                            device="cpu")
    else:
        heads = make_heads_dict(3, kps, rotated)
        module = JaxDLASeg(heads=heads, **NARROW)
        variables = jax.jit(lambda k, x: module.init(k, x, train=False))(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
        backend = SimpleNamespace(module=module, rotated_boxes=rotated,
                                  down_ratio=4)
        port = models.build("dla", num_classes=3, num_keypoints=kps,
                            rotated_boxes=rotated, dcn_impl="xla",
                            device="cpu", **NARROW)
    variables = randomise_stats(jax.tree.map(np.asarray, dict(variables)), 1)
    port.module.load_state_dict(state_dict_from_jax(variables, kind))
    state = SimpleNamespace(params=variables["params"],
                            batch_stats=variables["batch_stats"])
    return backend, state, port


def image(size, batch=2, seed=2):
    return np.random.RandomState(seed).randn(batch, size, size, 3).astype(
        np.float32)


def nchw(x):
    return torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def scaled_close(got, want, tol, name):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol,
                               atol=tol * scale, err_msg=name)


def untied(scores, gap=1e-4):
    """Mask of the top-k entries whose score differs from both neighbours
    by more than ``gap`` (their rank cannot swap under f32 noise)."""
    s = np.asarray(scores)
    diff = np.abs(np.diff(s, axis=-1)) > gap
    ok = np.ones_like(s, bool)
    ok[..., 1:] &= diff
    ok[..., :-1] &= diff
    return ok & (s > gap)


CASES = {"resnet18": ("resnet", 64, False, 0),
         "dla_dcn": ("dla", 128, False, 0),
         "dla_rotated_kps": ("dla", 128, True, 5)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_serving_matches_jax(case):
    kind, size, rotated, kps = CASES[case]
    backend, state, port = jax_and_port(kind, size, rotated, kps)
    x = image(size)
    want = jax.jit(make_serving_fn(backend, state, (size, size),
                                   max_detections=K))(jnp.asarray(x))
    with torch.no_grad():
        got = export.ServingModule(port, max_detections=K)(nchw(x))
    assert len(got) == len(want) == (4 if kps else 3)
    boxes, scores, classes = (np.asarray(t) for t in want[:3])
    assert got[0].shape == boxes.shape == (2, K, 5 if rotated else 4)
    scaled_close(got[1].numpy(), scores, 1e-5, "scores")
    ok = untied(scores)
    assert ok.sum() >= K  # most of the top-k is comparable
    scaled_close(got[0].numpy()[ok], boxes[ok], 1e-4, "boxes")
    np.testing.assert_array_equal(got[2].numpy()[ok], classes[ok])
    if kps:
        assert got[3].shape == (2, K, kps, 2)
        scaled_close(got[3].numpy()[ok], np.asarray(want[3])[ok], 1e-4,
                     "keypoints")

    raw = jax.jit(make_serving_fn(backend, state, (size, size),
                                  with_decode=False))(jnp.asarray(x))
    with torch.no_grad():
        heads = export.ServingModule(port, with_decode=False)(nchw(x))
    assert set(heads) == set(raw)
    for k, v in raw.items():
        scaled_close(heads[k].numpy().transpose(0, 2, 3, 1), v, 1e-4, k)


def test_rotated_boxes_keep_their_angle():
    """Rotated boxes: the four geometry columns are scaled by
    ``down_ratio``, the angle (degrees) is not."""
    port = models.build("dla", num_classes=3, rotated_boxes=True,
                        dcn_impl="xla", device="cpu", **NARROW)
    serving = export.ServingModule(port, max_detections=K)
    x = nchw(image(64, batch=1))
    with torch.no_grad():
        boxes = serving(x)[0]
        heads = serving.net(x)
        dets = export.decode_detections(
            export.sigmoid_clamped(heads["hm"]), heads["wh"], heads["reg"],
            k=K, rotated=True)
    torch.testing.assert_close(boxes[..., :4], dets[..., :4] * 4)
    torch.testing.assert_close(boxes[..., 4], dets[..., 4])


@pytest.fixture(scope="module")
def dla_artifacts(tmp_path_factory):
    """The narrow DLA on the kernel path (its CPU twin), exported with and
    without decode, and its eager outputs on one input."""
    out = tmp_path_factory.mktemp("artifacts")
    port = models.build("dla", num_classes=3, dcn_impl="cuda", seed=3,
                        device="cpu", **NARROW)
    x = nchw(image(128, batch=1, seed=5))
    made = {}
    for with_decode in (True, False):
        serving = export.ServingModule(port, max_detections=K,
                                       with_decode=with_decode)
        program = export.export_program(serving, (1, 3, 128, 128))
        base = out / ("dla" if with_decode else "dla_wd")
        with torch.no_grad():
            eager = serving(x)
        made[with_decode] = (export.export_pt2(program, base),
                             export.export_opt(program, base), eager)
    return x, made


def dcn_ops(program):
    """The ``centernet_uda`` ops of ``program``'s graph, one entry a node."""
    return sorted(str(n.target) for n in program.graph.nodes
                  if n.op == "call_function"
                  and str(n.target).startswith("centernet_uda."))


@pytest.mark.parametrize("with_decode", [True, False], ids=["decode", "wd"])
def test_artifacts_hold_the_dcn_ops_and_match_eager(dla_artifacts,
                                                    with_decode):
    x, made = dla_artifacts
    pt2, opt, eager = made[with_decode]
    assert pt2.name.endswith(".pt2") and opt.name.endswith(".opt.pt2")
    for path in (pt2, opt):
        program = export.load_artifact(path)
        # 16 DCN layers, one op node each: at 128 px the layer on the 4 x 4
        # map (W < 8) routes to dcn_sel_fwd, the 15 others to dcn_fwd
        ops = dcn_ops(program)
        assert ops.count("centernet_uda.dcn_fwd.default") == 15, ops
        assert ops.count("centernet_uda.dcn_sel_fwd.default") == 1, ops
        # the twin's own bilinear sampling (its floor of the sample
        # positions) is not traced into the graph in an op's place
        targets = {str(n.target) for n in program.graph.nodes}
        assert "aten.floor.default" not in targets, targets
        got = program.module()(x)
        if with_decode:
            for g, e in zip(got, eager):
                torch.testing.assert_close(g, e, rtol=0, atol=0)
        else:
            assert set(got) == set(eager)
            for k in eager:
                torch.testing.assert_close(got[k], eager[k], rtol=0, atol=0)


def test_fresh_process_serves_the_artifact(dla_artifacts, tmp_path):
    x, made = dla_artifacts
    pt2, _, eager = made[True]
    np.save(tmp_path / "x.npy", x.numpy())
    code = "\n".join([
        "import json, sys",
        "import numpy as np, torch",
        "torch.set_num_threads(2)",
        "from centernet_uda_torch.export import load_artifact",
        f"program = load_artifact({str(pt2)!r})",
        f"x = torch.tensor(np.load({str(tmp_path / 'x.npy')!r}))",
        "boxes, scores, classes = program.module()(x)",
        "print(json.dumps({'scores': scores.tolist(),",
        "                  'boxes': boxes.tolist(),",
        "                  'tf32': torch.backends.cudnn.allow_tf32",
        "                  or torch.backends.cuda.matmul.allow_tf32,",
        "                  'jax': any(m.split('.')[0] in ('jax', 'flax',",
        "                             'centernet_uda_tpu') for m in",
        "                             sys.modules)}))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=180,
                         env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin",
                              "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert not got["jax"]
    assert not got["tf32"]  # the artifact computes in float32
    np.testing.assert_array_equal(np.float32(got["scores"]),
                                  eager[1].numpy())
    np.testing.assert_array_equal(np.float32(got["boxes"]),
                                  eager[0].numpy())


def test_export_cli_on_a_trained_run(tmp_path, monkeypatch):
    img_dir, anno = make_tiny_coco(tmp_path / "coco", num_images=4,
                                   size=(64, 64), num_classes=3, seed=3)
    overrides = ["experiment=baseline", "dcn_impl=cuda", "epochs=1",
                 "batch_size=2", "num_workers=0", "max_detections=10",
                 "model.backend.params.num_classes=3",
                 "model.backend.params.levels=[1,1,1,1,1,1]",
                 "model.backend.params.channels=[4,8,8,16,16,32]",
                 "model.backend.params.head_conv=8"]
    for phase in ("training", "validation"):
        overrides += [f"datasets.{phase}.params.image_folder={img_dir}",
                      f"datasets.{phase}.params.annotation_file={anno}",
                      f"datasets.{phase}.params.input_size=[64,64]"]
    monkeypatch.chdir(tmp_path)
    train.main(overrides, device="cpu")
    run = tmp_path / "outputs" / "baseline"
    assert (run / "model_last.ckpt").is_file()

    paths = export.main(["-e", "baseline", "-i", "96", "64", "-b", "2",
                         "--max-detections", "7", "--formats", "pt2", "opt",
                         "--outputs-dir", str(tmp_path / "outputs"),
                         "--device", "cpu"])
    assert [p.name for p in paths] == ["centernet_dla_64x96.pt2",
                                       "centernet_dla_64x96.opt.pt2"]
    wd = export.main(["-e", "baseline", "-i", "64", "64", "-wd", "-l",
                      "best", "--outputs-dir", str(tmp_path / "outputs"),
                      "--device", "cpu"])
    assert [p.name for p in wd] == ["centernet_dla_64x64_wd.pt2"]

    # the artifact is the checkpoint's model: the eager serving module of
    # build_model gives the same detections
    cfg = export.config_lib.load_composed(str(run / "config.yaml"))
    backend = export.build_model(cfg, run / "model_last.ckpt", "cpu")
    x = torch.randn(2, 3, 64, 96, generator=torch.Generator().manual_seed(0))
    want = export.ServingModule(backend, max_detections=7)(x)
    got = export.load_artifact(paths[0]).module()(x)
    assert got[0].shape == (2, 7, 4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.detach(), rtol=0, atol=0)
    assert dcn_ops(export.load_artifact(paths[1]))


def test_export_cli_refuses_a_missing_checkpoint(tmp_path):
    run = tmp_path / "outputs" / "baseline"
    run.mkdir(parents=True)
    (run / "config.yaml").write_text((ROOT / "configs" / "defaults.yaml")
                                     .read_text())
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        export.main(["-e", "baseline", "--outputs-dir",
                     str(tmp_path / "outputs"), "--device", "cpu"])
