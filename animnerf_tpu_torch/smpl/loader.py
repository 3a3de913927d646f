"""Chumpy-free unpickling of SMPL-family ``.pkl`` files and frame params.

Copy of the JAX package's ``smpl/loader.py::load_pickle``: official SMPL
pickles embed ``chumpy`` arrays and scipy sparse matrices, which are
unpickled here without chumpy by a stub class whose pickled ``__dict__``
holds the wrapped numpy array.
"""

from __future__ import annotations

import io
import pickle
from typing import Any

import numpy as np


class _ChumpyStub:
    """Stand-in for chumpy.Ch — pickled state lands in __dict__."""

    def __init__(self, *args, **kwargs):
        pass


class _ForgivingUnpickler(pickle.Unpickler):
    _STUBBED_MODULES = ("chumpy",)

    def find_class(self, module: str, name: str):
        if any(module == m or module.startswith(m + ".")
               for m in self._STUBBED_MODULES):
            return _ChumpyStub
        return super().find_class(module, name)


def _unwrap(value: Any) -> Any:
    """Convert chumpy stubs / scipy sparse / object arrays to plain numpy."""
    if isinstance(value, _ChumpyStub):
        inner = value.__dict__.get("x")
        if inner is None:
            for v in value.__dict__.values():
                if isinstance(v, np.ndarray):
                    inner = v
                    break
        return _unwrap(inner)
    if hasattr(value, "todense"):  # scipy sparse
        return np.asarray(value.todense())
    if isinstance(value, np.ndarray) and value.dtype == object:
        return np.asarray([_unwrap(v) for v in value])
    return value


def load_pickle(path: str, latin1: bool = True) -> dict:
    """Unpickle a (possibly chumpy-bearing) pkl into plain numpy types.
    Only for files this project or the SMPL distribution wrote: unpickling
    runs code named by the file."""
    with open(path, "rb") as f:
        data = f.read()
    up = _ForgivingUnpickler(io.BytesIO(data),
                             encoding="latin1" if latin1 else "ASCII")
    raw = up.load()
    if isinstance(raw, dict):
        return {k: _unwrap(v) for k, v in raw.items()}
    return raw
