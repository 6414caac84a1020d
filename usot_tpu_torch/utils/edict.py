"""Minimal attribute-access dict: the port's own copy of
`usot_tpu/utils/edict.py`.

Behaves like a nested dict whose keys are also attributes. Used by the
config system (ref: lib/config/config_usot.py uses `easydict`).
"""
from __future__ import annotations


class EDict(dict):
    """dict with attribute access; nested dicts are converted recursively."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        if d:
            for k, v in dict(d).items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, EDict):
            value = EDict(value)
        elif isinstance(value, (list, tuple)):
            value = type(value)(
                EDict(v) if isinstance(v, dict) and not isinstance(v, EDict) else v
                for v in value
            )
        super().__setitem__(key, value)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def copy(self) -> "EDict":
        out = EDict()
        for k, v in self.items():
            out[k] = v.copy() if isinstance(v, EDict) else v
        return out
