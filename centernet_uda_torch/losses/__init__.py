"""Loss registry: ``build`` resolves the reference-style dotted names of the
experiment YAMLs, e.g. ``centernet.DetectionLoss``. The UDA losses are not
ported yet (ROADMAP A8)."""

from centernet_uda_torch.losses.centernet import (
    DetectionLoss,
    focal_loss,
    reg_l1_loss,
)

_REGISTRY = {"centernet.DetectionLoss": DetectionLoss}


def build(name: str, **params):
    """Instantiate a loss by its reference-style dotted name."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown loss '{name}'; available: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**params)


__all__ = ["build", "DetectionLoss", "focal_loss", "reg_l1_loss"]
