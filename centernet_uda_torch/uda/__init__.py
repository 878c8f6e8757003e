"""Trainer registry: ``build(name, **params)`` resolves the first key of the
config's ``model.uda`` mapping, bare or dotted, as
``centernet_uda_tpu/uda/__init__.py`` does; ``params`` are that key's
mapping plus ``device``."""

from centernet_uda_torch.uda.adversarial_entropy_minimization import (
    AdversarialEntropyMinimization,
)
from centernet_uda_torch.uda.base import Model
from centernet_uda_torch.uda.entropy_minimization import EntropyMinimization
from centernet_uda_torch.uda.fda import FDA
from centernet_uda_torch.uda.max_squares_minimization import (
    MaxSquaresMinimization,
)

_REGISTRY = {
    "Model": Model,
    "EntropyMinimization": EntropyMinimization,
    "MaxSquaresMinimization": MaxSquaresMinimization,
    "AdversarialEntropyMinimization": AdversarialEntropyMinimization,
    "FDA": FDA,
    "base.Model": Model,
    "entropy_minimization.EntropyMinimization": EntropyMinimization,
    "max_squares_minimization.MaxSquaresMinimization": MaxSquaresMinimization,
    "adversarial_entropy_minimization.AdversarialEntropyMinimization":
        AdversarialEntropyMinimization,
    "fda.FDA": FDA,
}


def build(name: str, **params) -> Model:
    """Build a trainer by its reference-style name."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown UDA method '{name}'; available: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**params)


__all__ = ["build", "Model", "EntropyMinimization", "MaxSquaresMinimization",
           "AdversarialEntropyMinimization", "FDA"]
