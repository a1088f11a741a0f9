"""Registries and config-driven construction, the mmcv convention.

Counterpart of ciaosr_tpu/config/registry.py. ``build_from_cfg({'type':
'SRFolderDataset', ...}, DATASETS)`` looks the type up by name; a class
object in ``type`` is called as it is.
"""

from __future__ import annotations

import copy
from typing import Any, Callable


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._registry: dict[str, Any] = {}

    def register(self, obj: Any = None, *, name: str | None = None):
        def _do(o):
            key = name or o.__name__
            if key in self._registry and self._registry[key] is not o:
                raise KeyError(f"{key} already registered in {self.name}")
            self._registry[key] = o
            return o
        if obj is None:
            return _do
        return _do(obj)

    def get(self, key: str) -> Any:
        if key not in self._registry:
            raise KeyError(
                f"'{key}' not found in registry '{self.name}'. "
                f"Available: {sorted(self._registry)}")
        return self._registry[key]

    def __contains__(self, key: str) -> bool:
        return key in self._registry


MODELS = Registry("models")
BACKBONES = Registry("backbones")
DATASETS = Registry("datasets")
PIPELINES = Registry("pipelines")
LOSSES = Registry("losses")
COMPONENTS = Registry("components")


def build_from_cfg(cfg: dict, registry: Registry,
                   default_args: dict | None = None) -> Any:
    """Instantiate ``cfg['type']`` with the remaining keys as kwargs."""
    if cfg is None:
        return None
    cfg = copy.deepcopy(dict(cfg))
    obj_type = cfg.pop("type")
    if isinstance(obj_type, str):
        cls: Callable = registry.get(obj_type)
    else:
        cls = obj_type
    if default_args:
        for k, v in default_args.items():
            cfg.setdefault(k, v)
    return cls(**cfg)
