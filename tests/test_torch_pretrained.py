"""The backend's ``pretrained`` param in the port against the JAX package
(CPU).

``pretrained: <path>``: a trunk ``.pth`` in the trunk's bare naming
(torchvision's ResNet and MobileNetV2, the DLA zoo's, EfficientNet-
PyTorch's), written from the port's own random trunk, loads into the trunk
alone (every other entry keeps its fresh value; a key outside the trunk,
such as ``fc.weight``, is ignored), as the JAX package's
``load_backbone_pretrained`` loads it. ``pretrained: true`` with an empty
torch hub cache raises on both sides, and so does a missing path.
"""

import jax
import numpy as np
import pytest
import torch

from centernet_uda_tpu.models import common as jax_common
from centernet_uda_tpu.models import dla as jax_dla
from centernet_uda_tpu.models import efficientnet as jax_effnet
from centernet_uda_tpu.models import mobilenetv2 as jax_mnv2
from centernet_uda_tpu.models import resnet as jax_resnet
from centernet_uda_tpu.ops import dcn as jax_dcn
from centernet_uda_tpu.utils import torch_import
from centernet_uda_torch import models as port_models
from centernet_uda_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(2)

NUM_CLASSES, SIZE = 3, 64
LEVELS, CHANNELS, HEAD_CONV = [1, 1, 1, 1, 1, 1], [4, 8, 8, 16, 16, 32], 8


def _resnet_trunk_name(key):
    index, _, rest = key[len("base."):].partition(".")
    return {"0": "conv1", "1": "bn1"}.get(
        index, f"layer{int(index) - 3}") + "." + rest


TRUNK_NAMES = {  # the port's key -> the trunk file's key
    "resnet": _resnet_trunk_name,
    "dla": lambda k: k[len("base."):],
    "mobilenetv2": lambda k: "features." + k[len("base."):],
    "efficientnet": lambda k: k[len("base."):],
}
PRETRAINED_CASES = {
    "resnet18": ("resnet", dict(num_layers=18),
                 lambda p: jax_resnet.build(18, NUM_CLASSES, pretrained=p)),
    "dla34": ("dla", dict(levels=LEVELS, channels=CHANNELS,
                          head_conv=HEAD_CONV), None),
    "mobilenetv2": ("mobilenetv2", {},
                    lambda p: jax_mnv2.build(NUM_CLASSES, pretrained=p)),
    "efficientnet-b0": ("efficientnet", dict(variant="b0", use_skip=True),
                        lambda p: jax_effnet.build(NUM_CLASSES, "b0",
                                                   use_skip=True,
                                                   pretrained=p)),
}


def narrow_jax_dla(path):
    heads = jax_common.make_heads_dict(NUM_CLASSES, 0, False)
    return jax_common.Backend(
        module=jax_dla.DLASeg(heads=heads, head_conv=HEAD_CONV,
                              levels=LEVELS, channels=CHANNELS),
        down_ratio=4, rotated_boxes=False, num_classes=NUM_CLASSES,
        num_keypoints=0, heads=heads, name="dla34",
        extra={"pretrained": path})


@pytest.mark.parametrize("name", list(PRETRAINED_CASES))
def test_pretrained_path_loads_the_trunk_as_jax_does(name, tmp_path):
    family, params, jax_build = PRETRAINED_CASES[name]
    source = port_models.build(family, num_classes=NUM_CLASSES, seed=5,
                               device="cpu", **params).module
    trunk = {TRUNK_NAMES[family](k): v for k, v in
             source.state_dict().items() if k.startswith("base.")}
    trunk["fc.weight"] = torch.zeros(2, 2)  # not part of the trunk
    path = tmp_path / f"{name}.pth"
    torch.save(trunk, path)

    fresh = port_models.build(family, num_classes=NUM_CLASSES, seed=7,
                              device="cpu", **params).module
    got = port_models.build(family, num_classes=NUM_CLASSES, seed=7,
                            pretrained=str(path), device="cpu",
                            **params).module.state_dict()
    for key, value in got.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key.startswith("base."):
            assert torch.equal(value, source.state_dict()[key]), key
        else:
            assert torch.equal(value, fresh.state_dict()[key]), key

    # the JAX package's loader on the same file fills the same trunk
    backend = (jax_build(str(path)) if jax_build is not None
               else narrow_jax_dla(str(path)))
    old = jax_dcn.get_pallas_default()
    jax_dcn.set_pallas_default("xla")
    try:
        variables = jax.tree.map(np.asarray, backend.init(
            jax.random.PRNGKey(0), (SIZE, SIZE)))
    finally:
        jax_dcn.set_pallas_default(old)
    loaded = torch_import.load_backbone_pretrained(backend, variables)
    want = state_dict_from_jax(jax.tree.map(np.asarray, dict(loaded)),
                               backend.name)
    for key, value in want.items():
        if key.startswith("base.") and not key.endswith(
                "num_batches_tracked"):
            assert torch.equal(got[key], value), key


def test_pretrained_true_without_cache_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no cached weights"):
        port_models.build("resnet", num_layers=18, num_classes=3,
                          pretrained=True, device="cpu")
    with pytest.raises(FileNotFoundError, match="no cached weights"):
        torch_import.resolve_pretrained_path("resnet18", True)
    with pytest.raises(FileNotFoundError, match="not found"):
        port_models.build("resnet", num_layers=18, num_classes=3,
                          pretrained=str(tmp_path / "missing.pth"),
                          device="cpu")
