"""Backend registry: ``build(name, **params)`` resolves the config's
``model.backend.name`` and passes ``params`` (the config's backend params
plus ``dcn_impl``, ``dtype``, ``seed`` and ``device``) to the backend's
``build``: ``dla``, ``mobilenetv2``, ``resnet`` and ``efficientnet``, each
imported when first built."""

from typing import Callable, Dict

from centernet_uda_torch.models.common import Backend


def _dla_build(**params) -> Backend:
    from centernet_uda_torch.models import dla

    return dla.build(**params)


def _mobilenetv2_build(**params) -> Backend:
    from centernet_uda_torch.models import mobilenetv2

    return mobilenetv2.build(**params)


def _resnet_build(**params) -> Backend:
    from centernet_uda_torch.models import resnet

    return resnet.build(**params)


def _efficientnet_build(**params) -> Backend:
    from centernet_uda_torch.models import efficientnet

    return efficientnet.build(**params)


_REGISTRY: Dict[str, Callable[..., Backend]] = {
    "dla": _dla_build, "mobilenetv2": _mobilenetv2_build,
    "resnet": _resnet_build, "efficientnet": _efficientnet_build}


def build(name: str, **params) -> Backend:
    """Build a backend by config name; ``device`` defaults to ``"cuda"``."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown backend '{name}'; available: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**params)
