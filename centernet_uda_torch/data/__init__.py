"""Host-side data pipeline: COCO parsing, augmentation, target encoding,
batching.

The registry resolves the config's ``datasets.<phase>.name`` (``coco``,
``coco_merger``) as ``centernet_uda_tpu/data/__init__.py`` does, so the
experiment YAMLs work unchanged. Importing it needs numpy only; OpenCV and
PIL are imported where an image needs them (``data/coco.py``).
"""

from typing import Callable, Dict


def _coco(**params):
    from centernet_uda_torch.data.coco import Dataset

    return Dataset(**params)


def _coco_merger(**params):
    from centernet_uda_torch.data.coco_merger import Dataset

    return Dataset(**params)


_REGISTRY: Dict[str, Callable] = {
    "coco": _coco,
    "coco_merger": _coco_merger,
}


def build(name: str, **params):
    if name not in _REGISTRY:
        raise KeyError(f"unknown dataset '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**params)


__all__ = ["build"]
