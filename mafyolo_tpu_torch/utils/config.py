"""Executable-python experiment configs (counterpart of
mafyolo_tpu/utils/config.py:13-76).

A configs/*.py file defines module-level dicts (`model`, `solver`,
`data_aug`); `Config.fromfile` runs it and wraps them in attribute dicts.
`yaml` is imported only for a .yml/.yaml config: the card's machine has no
PyYAML.
"""
from __future__ import annotations

import copy
import os


class ConfigDict(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, d=None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict) and not isinstance(v, ConfigDict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = self._wrap(value)

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self):
        out = {}
        for k, v in self.items():
            if isinstance(v, ConfigDict):
                v = v.to_dict()
            elif isinstance(v, (list, tuple)):
                v = type(v)(x.to_dict() if isinstance(x, ConfigDict) else x for x in v)
            out[k] = v
        return out


class Config(ConfigDict):
    """Experiment config: a python file defining module-level dicts."""

    @staticmethod
    def fromfile(filename: str) -> "Config":
        filename = os.path.abspath(os.path.expanduser(filename))
        if not os.path.isfile(filename):
            raise FileNotFoundError(filename)
        if filename.endswith(".py"):
            namespace: dict = {"__file__": filename}
            with open(filename, encoding="utf-8") as f:
                code = f.read()
            exec(compile(code, filename, "exec"), namespace)
            cfg = {k: v for k, v in namespace.items()
                   if not k.startswith("__") and not callable(v) and not isinstance(v, type(os))}
        elif filename.endswith((".yml", ".yaml", ".json")):
            import yaml
            with open(filename, encoding="utf-8") as f:
                cfg = yaml.safe_load(f)
        else:
            raise OSError(f"unsupported config type: {filename}")
        out = Config(cfg)
        dict.__setitem__(out, "_cfg_filename", filename)
        return out
