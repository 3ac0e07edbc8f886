"""Attribute-access mapping container used across the framework.

Provides the same ergonomics users of the reference toolchain expect
(reference deepmimo/general_utils.py:124-261): nested dict + dot access,
deep copies that duplicate numpy arrays, and a diff helper for catching
mistyped parameter names.
"""

from __future__ import annotations

from pprint import pformat
from typing import Any, Dict, Mapping, Optional

import numpy as np


class DotDict(Mapping):
    """Mapping with dot-notation access; nested dicts become DotDicts."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self._data = {}
        if data:
            for key, value in data.items():
                self._data[key] = (
                    DotDict(value)
                    if isinstance(value, dict) and not isinstance(value, DotDict)
                    else value
                )

    # -- attribute access -----------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError:
            raise AttributeError(key)

    def __setattr__(self, key: str, value: Any) -> None:
        if key == "_data":
            super().__setattr__(key, value)
        else:
            self[key] = value

    # -- mapping protocol -----------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, dict) and not isinstance(value, DotDict):
            value = DotDict(value)
        self._data[key] = value

    def __delitem__(self, key: str) -> None:
        del self._data[key]

    def __len__(self) -> int:
        return len(self._data)

    def __iter__(self):
        return iter(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def __dir__(self):
        return list(set(list(super().__dir__()) + list(self._data.keys())))

    # -- dict-like helpers ----------------------------------------------------
    def keys(self):
        return self._data.keys()

    def values(self):
        return self._data.values()

    def items(self):
        return self._data.items()

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def update(self, other: Dict[str, Any]) -> None:
        processed = {
            k: DotDict(v) if isinstance(v, dict) and not isinstance(v, DotDict) else v
            for k, v in other.items()
        }
        self._data.update(processed)

    def to_dict(self) -> Dict:
        out = {}
        for key, value in self._data.items():
            out[key] = value.to_dict() if isinstance(value, DotDict) else value
        return out

    def deepcopy(self) -> "DotDict":
        out = {}
        for key, value in self._data.items():
            if isinstance(value, DotDict):
                out[key] = value.deepcopy()
            elif isinstance(value, dict):
                out[key] = DotDict(value).deepcopy()
            elif isinstance(value, np.ndarray):
                out[key] = value.copy()
            else:
                out[key] = value
        return type(self)(out)

    def __repr__(self) -> str:
        return pformat(self._data)


def compare_two_dicts(dict1: Dict[str, Any], dict2: Dict[str, Any]) -> set:
    """Return the set of keys (recursively) present in dict1 but not dict2."""
    extra = set(dict1.keys()) - set(dict2.keys())
    for key, item in dict1.items():
        if isinstance(item, (dict, DotDict)) and key in dict2:
            extra |= compare_two_dicts(dict1[key], dict2[key])
    return extra


class PrintIfVerbose:
    """Callable that prints only when constructed with verbose=True."""

    def __init__(self, verbose: bool) -> None:
        self.verbose = verbose

    def __call__(self, message: str) -> None:
        if self.verbose:
            print(message)
