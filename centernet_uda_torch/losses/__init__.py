"""Loss registry: ``build`` resolves the reference-style dotted names of the
experiment YAMLs, e.g. ``centernet.DetectionLoss``; the UDA losses are
registered as ``centernet_uda_tpu/losses/__init__.py`` registers them."""

from centernet_uda_torch.losses.advent import AdventLoss
from centernet_uda_torch.losses.centernet import (
    DetectionLoss,
    focal_loss,
    reg_l1_loss,
)
from centernet_uda_torch.losses.entropy import EntropyLoss
from centernet_uda_torch.losses.max_square import MaxSquareLoss

_REGISTRY = {
    "centernet.DetectionLoss": DetectionLoss,
    "entropy.EntropyLoss": EntropyLoss,
    "advent.AdventLoss": AdventLoss,
    "max_square.MaxSquareLoss": MaxSquareLoss,
}


def build(name: str, **params):
    """Instantiate a loss by its reference-style dotted name."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown loss '{name}'; available: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**params)


__all__ = ["build", "DetectionLoss", "EntropyLoss", "AdventLoss",
           "MaxSquareLoss", "focal_loss", "reg_l1_loss"]
