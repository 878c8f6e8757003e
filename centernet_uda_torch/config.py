"""Configuration: the JAX package's hydra-compatible ``Config``/``compose``.

A copy of ``centernet_uda_tpu/config.py`` (``Config``, ``compose``,
``parse_overrides``), kept here so the port imports nothing of the JAX
package. It composes the shared ``configs/`` tree unchanged:
``compose(["experiment=baseline"])`` merges ``configs/defaults.yaml``, the
experiment overlay and dotted ``key=value`` overrides, in hydra's order.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import yaml


class Config:
    """An attribute-accessible nested dict (omegaconf-DictConfig-alike)."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        for k, v in (data or {}).items():
            self._data[k] = _wrap(v)

    # --- mapping protocol -------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __bool__(self) -> bool:
        return bool(self._data)

    def __eq__(self, other) -> bool:
        if isinstance(other, Config):
            return self.to_dict() == other.to_dict()
        if isinstance(other, dict):
            return self.to_dict() == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def keys(self):
        return self._data.keys()

    def values(self):
        return self._data.values()

    def items(self):
        return self._data.items()

    def to_dict(self) -> Dict[str, Any]:
        return {k: _unwrap(v) for k, v in self._data.items()}

    # --- merge / override -------------------------------------------------
    def merge(self, other: "Config | Dict[str, Any]") -> "Config":
        """Deep-merge ``other`` into a copy of self (other wins; dicts recurse,
        everything else — including lists — is replaced, like omegaconf)."""
        out = Config(self.to_dict())
        src = other.to_dict() if isinstance(other, Config) else other
        for k, v in src.items():
            if (
                k in out._data
                and isinstance(out._data[k], Config)
                and isinstance(v, dict)
            ):
                out._data[k] = out._data[k].merge(v)
            else:
                out._data[k] = _wrap(copy.deepcopy(v))
        return out

    def set_dotted(self, dotted: str, value: Any) -> None:
        """Set ``a.b.c`` = value, creating intermediate nodes."""
        parts = dotted.split(".")
        node = self
        for p in parts[:-1]:
            nxt = node._data.get(p)
            if not isinstance(nxt, Config):
                nxt = Config()
                node._data[p] = nxt
            node = nxt
        node._data[parts[-1]] = _wrap(value)

    def get_dotted(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for p in dotted.split("."):
            if isinstance(node, Config) and p in node:
                node = node[p]
            else:
                return default
        return node


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, dict):
        return Config(value)
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def _unwrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value.to_dict()
    if isinstance(value, list):
        return [_unwrap(v) for v in value]
    return value


def _parse_value(raw: str) -> Any:
    """Parse a CLI override value with YAML semantics (hydra-compatible)."""
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def parse_overrides(argv: List[str]) -> List[Tuple[str, Any]]:
    """Parse hydra-style ``key=value`` CLI arguments."""
    overrides = []
    for arg in argv:
        if "=" not in arg:
            raise ValueError(
                f"override '{arg}' is not of the form key=value "
                "(hydra-style CLI)"
            )
        key, raw = arg.split("=", 1)
        overrides.append((key.strip(), _parse_value(raw)))
    return overrides


def compose(
    argv: List[str],
    config_dir: str = "configs",
    defaults_name: str = "defaults.yaml",
) -> Config:
    """Compose defaults + experiment overlay + CLI overrides (hydra order).

    ``experiment=<name>`` selects ``<config_dir>/experiment/<name>.yaml``
    exactly like the reference's hydra setup (train.py:70,
    configs/defaults.yaml:118-121).
    """
    config_dir_path = Path(config_dir)
    with open(config_dir_path / defaults_name) as f:
        cfg = Config(yaml.safe_load(f) or {})

    overrides = parse_overrides(argv)

    for key, value in overrides:
        if key == "experiment":
            overlay_path = config_dir_path / "experiment" / f"{value}.yaml"
            if not overlay_path.exists():
                available = sorted(
                    p.stem for p in (config_dir_path / "experiment").glob("*.yaml")
                )
                raise FileNotFoundError(
                    f"experiment '{value}' not found at {overlay_path}; "
                    f"available: {available}"
                )
            with open(overlay_path) as f:
                overlay = yaml.safe_load(f) or {}
            cfg = cfg.merge(overlay)
            cfg.set_dotted("experiment", value)

    for key, value in overrides:
        if key != "experiment":
            cfg.set_dotted(key, value)

    return cfg
