"""Restricted reader for PyTorch / Lightning checkpoint files — the port's
copy of ``animnerf_tpu/utils/torch_pickle.py``.

A ``.ckpt`` / ``.pth`` written by ``torch.save`` (zip serialization) is a
zip archive holding ``data.pkl`` (a pickle whose tensors are
persistent-id references) and one raw little-endian buffer per storage
under ``data/``. This module unpickles it into plain numpy arrays and
dicts, without torch and without the classes the hyper-parameters name
(yacs ``CfgNode``, Lightning's own), which the card's machine cannot
import.

Unlike the JAX package's reader, which imports any other module the file
names, ``find_class`` resolves only an allowlist: torch's tensor and
parameter rebuild functions and storage markers, ``collections.OrderedDict``
(-> dict), ``argparse.Namespace`` (-> a dict of its attributes) and
numpy's own array reconstructors, scalars and dtypes. Every other global
becomes a ``Placeholder`` that records its name and arguments, so loading
a checkpoint runs no code it names (``os.system``, ``builtins.eval``, ...).
A ``dict`` subclass outside the allowlist, such as the yacs ``CfgNode``
the reference freezes into every Lightning checkpoint, reads as a plain
dict of the items the pickle gives it (``SETITEMS``), nested sections
too; its ``__dict__`` state (yacs' ``__immutable__`` and the like) adds
no keys. That is what the JAX package's reader returns where the class
is importable: a dict with those items. A yacs ``CfgNode`` with no items
reads as an empty dict. A valid checkpoint's tensors come back as the JAX
reader's, bit for bit.
"""

from __future__ import annotations

import io
import pickle
import zipfile
from typing import Any

import numpy as np

_DTYPES = {
    "FloatStorage": np.float32,
    "DoubleStorage": np.float64,
    "HalfStorage": np.float16,
    "BFloat16Storage": None,  # widened to float32 below
    "LongStorage": np.int64,
    "IntStorage": np.int32,
    "ShortStorage": np.int16,
    "CharStorage": np.int8,
    "ByteStorage": np.uint8,
    "BoolStorage": np.bool_,
}

# numpy's own reconstructors and types, under both package layouts
_NUMPY = {
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
}


class _Storage:
    def __init__(self, data: bytes, dtype_name: str):
        self.data = data
        self.dtype_name = dtype_name

    def as_numpy(self) -> np.ndarray:
        if self.dtype_name == "BFloat16Storage":
            raw = np.frombuffer(self.data, dtype=np.uint16)
            return (raw.astype(np.uint32) << 16).view(np.float32)
        return np.frombuffer(self.data, dtype=_DTYPES[self.dtype_name])


def _rebuild_tensor_v2(storage: _Storage, storage_offset, size, stride,
                       requires_grad=False, backward_hooks=None,
                       metadata=None) -> np.ndarray:
    flat = storage.as_numpy()
    if not size:
        return flat[storage_offset].copy()
    itemsize = flat.itemsize
    strided = np.lib.stride_tricks.as_strided(
        flat[storage_offset:],
        shape=tuple(size),
        strides=tuple(s * itemsize for s in stride),
    )
    return np.ascontiguousarray(strided)


def _rebuild_parameter(data, requires_grad=True, backward_hooks=None,
                       state=None):
    return data


class Placeholder:
    """Stands in for a global outside the allowlist: it records the
    module and name (``_global``), the arguments it was called with and
    any state or items the pickle gives it, and runs nothing. Its fields
    are set in ``__new__``: pickle's ``NEWOBJ`` creates an instance
    without calling ``__init__``."""

    _global = ("", "")

    def __new__(cls, *args, **kwargs):
        self = super().__new__(cls)
        self.args = args
        self.kwargs = kwargs
        self.state = None
        self.items = {}
        self.elements = []
        return self

    def __setstate__(self, state):
        self.state = state

    def __setitem__(self, key, value):
        self.items[key] = value

    def append(self, value):
        self.elements.append(value)

    def extend(self, values):
        self.elements.extend(values)

    def __repr__(self) -> str:
        return "Placeholder(%s.%s)" % self._global


# dict subclasses that read as a dict even when the pickle gives no items
_DICT_GLOBALS = {("yacs.config", "CfgNode")}


def _reads_as_dict(obj: Placeholder) -> bool:
    return bool(obj.items) or (obj._global in _DICT_GLOBALS
                               and not obj.args and not obj.kwargs)


def _plain(obj: Any, seen: dict) -> Any:
    """Replace every placeholder filled by ``SETITEMS`` (and every empty
    yacs ``CfgNode``) by the dict of its items, through dicts, lists and
    tuples; an object the pickle shares stays shared. ``seen`` maps an
    object's id to (the object, its result): holding the object keeps its
    id from being reused while the walk runs."""
    key = id(obj)
    if key in seen:
        return seen[key][1]
    if isinstance(obj, Placeholder) and _reads_as_dict(obj):
        out = {}
        seen[key] = (obj, out)
        for k, v in obj.items.items():
            out[k] = _plain(v, seen)
        return out
    seen[key] = (obj, obj)
    if isinstance(obj, dict):
        for k, v in obj.items():
            obj[k] = _plain(v, seen)
    elif isinstance(obj, list):
        obj[:] = [_plain(v, seen) for v in obj]
    elif isinstance(obj, tuple):
        seen[key] = (obj, tuple(_plain(v, seen) for v in obj))
    return seen[key][1]


class _Namespace(dict):
    """``argparse.Namespace`` as the dict of its attributes."""

    def __setstate__(self, state):
        self.update(state or {})


def _placeholder(module: str, name: str) -> type:
    return type(name, (Placeholder,), {"_global": (module, name)})


class _RestrictedUnpickler(pickle.Unpickler):
    def __init__(self, f, zf: zipfile.ZipFile, prefix: str):
        super().__init__(f, encoding="latin1")
        self._zf = zf
        self._prefix = prefix

    def find_class(self, module: str, name: str):
        if module == "torch._utils" and name in ("_rebuild_tensor_v2",
                                                 "_rebuild_tensor"):
            return _rebuild_tensor_v2
        if module == "torch._utils" and name in (
                "_rebuild_parameter", "_rebuild_parameter_with_state"):
            return _rebuild_parameter
        if module == "torch" and name.endswith("Storage"):
            # dtype marker classes: keep the name for persistent_load
            return type(name, (), {})
        if module == "collections" and name == "OrderedDict":
            return dict
        if module == "argparse" and name == "Namespace":
            return _Namespace
        if (module, name) in _NUMPY:
            return super().find_class(module, name)
        return _placeholder(module, name)

    def persistent_load(self, pid: Any):
        # ('storage', <storage type marker>, key, location, numel)
        if isinstance(pid, tuple) and pid and pid[0] == "storage":
            storage_type, key = pid[1], pid[2]
            tname = getattr(storage_type, "__name__", None) or str(pid[1])
            for cand in _DTYPES:
                if cand in str(tname) or cand in str(pid):
                    tname = cand
                    break
            else:
                tname = "FloatStorage"
            data = self._zf.read(f"{self._prefix}/data/{key}")
            return _Storage(data, tname)
        raise pickle.UnpicklingError(f"unsupported persistent id {pid!r}")


def load_torch_checkpoint(path: str) -> Any:
    """Load a torch zip-serialized checkpoint into numpy arrays, dicts and
    ``Placeholder``s, without torch and without running code it names;
    pickled dict subclasses come back as plain dicts."""
    with zipfile.ZipFile(path) as zf:
        pkl_names = [n for n in zf.namelist() if n.endswith("data.pkl")]
        if not pkl_names:
            raise ValueError(f"{path!r} is not a torch zip checkpoint")
        pkl_name = pkl_names[0]
        prefix = pkl_name[: -len("/data.pkl")]
        with zf.open(pkl_name) as f:
            up = _RestrictedUnpickler(io.BytesIO(f.read()), zf, prefix)
            return _plain(up.load(), {})
