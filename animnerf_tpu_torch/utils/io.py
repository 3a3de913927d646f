"""Pickle / JSON / OBJ io helpers — copy of ``animnerf_tpu/utils/io.py``."""

from __future__ import annotations

import json
import pickle

import numpy as np

from animnerf_tpu_torch.smpl.loader import (  # noqa: F401
    load_pickle as load_pickle_file,
)


def write_pickle_file(path: str, data) -> None:
    with open(path, "wb") as f:
        pickle.dump(data, f)


def load_json_file(path: str):
    with open(path) as f:
        return json.load(f)


def write_json_file(path: str, data) -> None:
    with open(path, "w") as f:
        json.dump(data, f, indent=1, default=str)


def save_obj(path: str, vertices: np.ndarray, faces=None) -> None:
    """Minimal wavefront OBJ writer (1-indexed faces)."""
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if faces is not None:
            for tri in np.asarray(faces):
                f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")


def load_obj(path: str):
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                faces.append([int(p.split("/")[0]) - 1 for p in parts[1:4]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)
