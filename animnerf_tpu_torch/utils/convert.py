"""Carry weights and state across from the JAX package's formats.

The port never imports the JAX package; it reads the arrays it writes:
flax NeRFMLP param dicts (numpy, flax ``(in, out)`` kernels), the body
model's arrays, and checkpoint directories (``anim_nerf.npz``,
``body_params.npz``, ``meta.json``, as ``training/checkpoints.py`` there
saves them).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

NERF_LAYERS = tuple(f"xyz_{i}" for i in range(8)) + (
    "sigma", "xyz_final", "dir_0", "rgb")


def _flat_items(d: dict, prefix: str = ""):
    for k, v in d.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _flat_items(v, key)
        else:
            yield key, v


def nerf_params_from_flax(d: dict) -> dict:
    """flax NeRFMLP params -> ``NeRFMLP`` state dict (float32 tensors).

    Accepts the nested pytree (``{"params": {"xyz_0": {"kernel", "bias"}}}``
    with or without the ``params`` level) or flat keys whose last two
    parts are ``<layer>/<kernel|bias>`` (``nerf/params/xyz_0/kernel`` as in
    ``anim_nerf.npz``). The flat keys must belong to one network."""
    found = {}
    for key, v in _flat_items(d):
        parts = key.split("/")
        if len(parts) < 2 or parts[-2] not in NERF_LAYERS \
                or parts[-1] not in ("kernel", "bias"):
            continue
        name = (parts[-2], parts[-1])
        if name in found:
            raise ValueError(f"{'/'.join(name)} appears twice: pass one "
                             "network's params (e.g. the 'nerf/' keys)")
        found[name] = np.asarray(v, np.float32)
    missing = [f"{n}/{p}" for n in NERF_LAYERS for p in ("kernel", "bias")
               if (n, p) not in found]
    if missing:
        raise KeyError(f"flax NeRFMLP params lack {missing}")
    state = {}
    for n in NERF_LAYERS:
        state[f"{n}.weight"] = torch.from_numpy(
            np.array(found[(n, "kernel")].T, order="C"))
        state[f"{n}.bias"] = torch.from_numpy(np.array(found[(n, "bias")]))
    return state


def body_model_from_arrays(v_template, shapedirs, posedirs, J_regressor,
                           lbs_weights, parents, faces,
                           extra_joint_idxs: Optional[np.ndarray] = None,
                           model_type: str = "smpl",
                           gender: str = "neutral"):
    """SMPL arrays (the loader's / ``make_rig``'s keys) -> ``BodyModel``
    with float32 CPU tensors."""
    from animnerf_tpu_torch.smpl.body_model import BodyModel

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))

    if extra_joint_idxs is None:
        extra_joint_idxs = np.zeros((0,), np.int32)
    return BodyModel(v_template=t(v_template), shapedirs=t(shapedirs),
                     posedirs=t(posedirs), J_regressor=t(J_regressor),
                     lbs_weights=t(lbs_weights),
                     parents=np.asarray(parents, np.int32),
                     faces=np.asarray(faces, np.int32),
                     extra_joint_idxs=np.asarray(extra_joint_idxs, np.int32),
                     model_type=model_type, gender=gender)


def load_checkpoint(path: str) -> dict:
    """Read a checkpoint directory of the JAX package ->
    {"meta": meta.json, "cfg": meta["cfg"],
     "anim_nerf": {"nerf": state dict, "nerf_fine": state dict},
     "body_params": {name: float32 array}}."""
    meta_file = os.path.join(path, "meta.json")
    if not os.path.isfile(meta_file):
        raise FileNotFoundError(f"no meta.json in checkpoint {path!r}")
    with open(meta_file) as f:
        meta = json.load(f)
    out = {"meta": meta, "cfg": meta.get("cfg", {})}
    nerf_file = os.path.join(path, "anim_nerf.npz")
    if os.path.isfile(nerf_file):
        with np.load(nerf_file) as data:
            groups: dict = {}
            for key in data.files:
                groups.setdefault(key.split("/")[0], {})[key] = data[key]
        out["anim_nerf"] = {net: nerf_params_from_flax(flat)
                            for net, flat in groups.items()}
    body_file = os.path.join(path, "body_params.npz")
    if os.path.isfile(body_file):
        with np.load(body_file) as data:
            out["body_params"] = {k: np.asarray(data[k], np.float32)
                                  for k in data.files}
    return out


def params_from_jax(params: dict) -> dict:
    """The JAX package's training params (numpy pytree: ``anim_nerf``
    {``nerf``, ``nerf_fine``} flax dicts and ``body_params``) ->
    {"anim_nerf": {"nerf": state dict, "nerf_fine": state dict},
     "body_params": {name: float32 tensor}} for
    ``AnimNeRFSystem.load_params``."""
    out = {"anim_nerf": {net: nerf_params_from_flax(p)
                         for net, p in params["anim_nerf"].items()},
           "body_params": {k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in params["body_params"].items()}}
    if "latent_codes" in params:
        raise NotImplementedError("latent codes are not ported yet")
    return out
