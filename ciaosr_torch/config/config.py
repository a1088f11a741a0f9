"""Executable-Python config loader (mmcv ``Config.fromfile``).

Counterpart of ciaosr_tpu/config/config.py. A config is a Python file
whose module-level names are the config: the file is exec'd, and its
globals, without dunder names, modules and functions, become an
attribute-accessible dict.
"""

from __future__ import annotations

import os
import types
from typing import Any


class ConfigDict(dict):
    """dict with attribute access, recursively applied on read."""

    def __getattr__(self, key: str) -> Any:
        try:
            v = self[key]
        except KeyError as e:
            raise AttributeError(key) from e
        return v

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, ConfigDict):
            return ConfigDict({k: ConfigDict._wrap(x) for k, x in v.items()})
        if isinstance(v, list):
            return [ConfigDict._wrap(x) for x in v]
        if isinstance(v, tuple):
            return tuple(ConfigDict._wrap(x) for x in v)
        return v


class Config:
    """Namespace over a config file's module globals."""

    def __init__(self, cfg_dict: dict, filename: str | None = None):
        object.__setattr__(self, "_cfg", ConfigDict(
            {k: ConfigDict._wrap(v) for k, v in cfg_dict.items()}))
        object.__setattr__(self, "filename", filename)

    @classmethod
    def fromfile(cls, path: str) -> "Config":
        path = os.path.abspath(path)
        mod = types.ModuleType("_ciaosr_config")
        mod.__file__ = path
        with open(path) as f:
            code = compile(f.read(), path, "exec")
        exec(code, mod.__dict__)
        # classes stay: a config may pass a class object as ``type``
        cfg = {k: v for k, v in vars(mod).items()
               if not k.startswith("__")
               and not isinstance(v, (types.ModuleType, type(os.path.join)))}
        return cls(cfg, filename=path)

    def __getattr__(self, key: str) -> Any:
        return getattr(object.__getattribute__(self, "_cfg"), key)

    def __setattr__(self, key: str, value: Any) -> None:
        self._cfg[key] = ConfigDict._wrap(value)

    def __contains__(self, key: str) -> bool:
        return key in self._cfg

    def get(self, key, default=None):
        return self._cfg.get(key, default)

    def keys(self):
        return self._cfg.keys()

    @property
    def text(self) -> str:
        if self.filename and os.path.exists(self.filename):
            with open(self.filename) as f:
                return f.read()
        return repr(self._cfg)
