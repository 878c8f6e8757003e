"""Evaluation registry: resolves the config's ``evaluation.<name>`` (``coco``)
as ``centernet_uda_tpu/evaluation/__init__.py`` does."""

from typing import Callable, Dict


def _coco(**params):
    from centernet_uda_torch.evaluation.coco import Evaluator

    return Evaluator(**params)


_REGISTRY: Dict[str, Callable] = {"coco": _coco}


def build(name: str, **params):
    if name not in _REGISTRY:
        raise KeyError(f"unknown evaluator '{name}'; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**params)


__all__ = ["build"]
