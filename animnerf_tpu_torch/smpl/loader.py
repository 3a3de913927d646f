"""Chumpy-free loading of SMPL-family model files and frame params.

Copy of the JAX package's ``smpl/loader.py``: official SMPL pickles embed
``chumpy`` arrays and scipy sparse matrices, which are unpickled here
without chumpy by a stub class whose pickled ``__dict__`` holds the
wrapped numpy array. ``load_model_data`` returns the body-model arrays in
the layout ``smpl/body_model.py::create`` takes; ``save_model_data``
writes them back in the reference's file layout.
"""

from __future__ import annotations

import io
import os
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


def resolve_model_file(model_path: str, model_type: str, gender: str) -> str:
    """The reference's layout: {model_path}/{MODEL_TYPE}_{GENDER}.pkl or
    {model_path}/{model_type}/{MODEL_TYPE}_{GENDER}.pkl, or a file."""
    if os.path.isfile(model_path):
        return model_path
    fname = f"{model_type.upper()}_{gender.upper()}.pkl"
    for cand in (os.path.join(model_path, fname),
                 os.path.join(model_path, model_type, fname)):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        f"No {model_type}/{gender} model file under {model_path!r} "
        f"(tried {fname})")


def load_model_data(model_path: str, model_type: str = "smpl",
                    gender: str = "neutral", num_betas: int = 10) -> dict:
    """An SMPL-family pkl -> float32 / int32 numpy arrays: v_template
    (V, 3), shapedirs (V, 3, num_betas), posedirs (9*(J-1), V*3),
    J_regressor (J, V) (dense, also from a scipy sparse matrix), parents
    (J,), lbs_weights (V, J), faces (F, 3), and the SMPL-H/X hand PCA
    (hand_components_l/r, hand_mean_l/r) when the file holds them."""
    raw = load_pickle(resolve_model_file(model_path, model_type, gender))
    shapedirs = np.asarray(raw["shapedirs"], dtype=np.float32)
    shapedirs = shapedirs[:, :, :min(num_betas, shapedirs.shape[-1])]
    posedirs = np.asarray(raw["posedirs"], dtype=np.float32)
    # (V, 3, P) on disk -> (P, V*3), one matmul in the blend
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T.copy()
    parents = np.asarray(raw["kintree_table"],
                         dtype=np.int64)[0].astype(np.int32)
    parents[0] = -1
    out = {
        "v_template": np.asarray(raw["v_template"], dtype=np.float32),
        "shapedirs": shapedirs,
        "posedirs": posedirs,
        "J_regressor": np.asarray(_unwrap(raw["J_regressor"]), np.float32),
        "parents": parents,
        "lbs_weights": np.asarray(raw["weights"], dtype=np.float32),
        "faces": np.asarray(raw["f"], dtype=np.int32),
    }
    for src, dst in (("hands_componentsl", "hand_components_l"),
                     ("hands_componentsr", "hand_components_r"),
                     ("hands_meanl", "hand_mean_l"),
                     ("hands_meanr", "hand_mean_r")):
        if src in raw:
            out[dst] = np.asarray(_unwrap(raw[src]), dtype=np.float32)
    return out


def save_model_data(path: str, data: dict) -> None:
    """Write a model dict in the reference's file layout (numpy arrays,
    posedirs as (V, 3, P), the root's parent as uint32 -1)."""
    posedirs = data["posedirs"]
    V = data["v_template"].shape[0]
    if posedirs.shape[0] != V:  # stored in matmul layout; undo
        posedirs = posedirs.T.reshape(V, 3, -1)
    parents = np.asarray(data["parents"]).astype(np.int64)
    kintree = np.stack([parents, np.arange(len(parents), dtype=np.int64)])
    kintree[0, 0] = 2**32 - 1
    raw = {
        "v_template": data["v_template"],
        "shapedirs": data["shapedirs"],
        "posedirs": posedirs,
        "J_regressor": data["J_regressor"],
        "kintree_table": kintree,
        "weights": data["lbs_weights"],
        "f": data["faces"],
    }
    with open(path, "wb") as f:
        pickle.dump(raw, f)
