"""Checkpoints in the JAX package's layout — counterpart of
``animnerf_tpu/training/checkpoints.py``.

A checkpoint directory holds one ``<group>.npz`` per parameter group under
the JAX package's key names and a ``meta.json`` with ``groups``, ``step``
and ``cfg``:

  * ``anim_nerf.npz``: ``<net>/params/<layer>/<kernel|bias>`` for the nets
    ``nerf``, ``nerf_fine`` and ``derf`` (DeRF), flax kernels (in, out);
  * ``body_params.npz``: the per-frame body parameters by name;
  * ``latent_codes.npz``: the per-frame codes, one array under the key
    "" (the JAX package's flattening of a bare array), when the model has
    them.

So the JAX package loads the port's checkpoints and the port loads the
JAX package's, by group (``model_names_to_load``). The port's optimizer,
scheduler and noise-generator states go to ``opt_state.pt`` beside them
(the JAX package's own ``opt_state.npz`` holds optax state, which the port
does not read: a JAX ``last`` resumes with its parameters, its step and a
fresh optimizer). ``CheckpointManager`` keeps the top k by a monitored
metric.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from animnerf_tpu_torch.utils.convert import (
    NERF_LAYERS,
    NET_LAYERS,
    load_checkpoint,
)

OPT_STATE = "opt_state.pt"


def nerf_params_to_flax(state: dict, net: str, layers=NERF_LAYERS) -> dict:
    """``NeRFMLP`` (or, with DeRF's layers, ``DeRFMLP``) state dict -> flat
    flax keys of one net (``<net>/params/<layer>/kernel`` (in, out) and
    ``.../bias``), the inverse of ``utils/convert.py::
    nerf_params_from_flax``."""
    out = {}
    for layer in layers:
        w = state[f"{layer}.weight"].detach().to("cpu", torch.float32)
        b = state[f"{layer}.bias"].detach().to("cpu", torch.float32)
        out[f"{net}/params/{layer}/kernel"] = np.ascontiguousarray(
            w.numpy().T)
        out[f"{net}/params/{layer}/bias"] = b.numpy().copy()
    return out


def system_params(system) -> dict:
    """The system's parameters as the JAX package's groups of flat numpy
    arrays: {"anim_nerf": {flax key: array}, "body_params": {name: array}}
    and, with latent codes, "latent_codes": {"": array}."""
    nerf = {}
    for net, layers in NET_LAYERS.items():
        module = getattr(system.scene, net, None)
        if module is not None:
            nerf.update(nerf_params_to_flax(module.state_dict(), net,
                                            layers))
    body = {k: p.detach().to("cpu", torch.float32).numpy().copy()
            for k, p in system.body_params.items()}
    out = {"anim_nerf": nerf, "body_params": body}
    if system.latent_codes is not None:
        out["latent_codes"] = {"": system.latent_codes.detach().to(
            "cpu", torch.float32).numpy().copy()}
    return out


def save_params(path: str, params: dict,
                metadata: Optional[dict] = None) -> None:
    """Write a checkpoint directory: one npz per group of ``params``
    ({group: {key: array}}) and meta.json (``metadata`` plus ``groups``)."""
    os.makedirs(path, exist_ok=True)
    for group, flat in params.items():
        np.savez(os.path.join(path, f"{group}.npz"), **flat)
    meta = dict(metadata or {})
    meta["groups"] = sorted(params.keys())
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1, default=str)


def load_metadata(path: str) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def load_params(path: str, system,
                groups: Optional[list] = None) -> None:
    """Load all (or the named) groups of a checkpoint into the system;
    groups the system lacks (latent codes of a model without them) and
    files that are missing leave its values as they are, as the JAX
    package's ``load_params``. A body parameter or codes of another shape
    raise."""
    ck = load_checkpoint(path)
    for group in groups if groups is not None else ck["meta"]["groups"]:
        if group == "anim_nerf" and "anim_nerf" in ck:
            for net, state in ck["anim_nerf"].items():
                module = getattr(system.scene, net, None)
                if module is None:
                    raise KeyError(f"checkpoint net {net!r} is not in the "
                                   "system")
                module.load_state_dict(state)
        elif group == "body_params" and "body_params" in ck:
            with torch.no_grad():
                for k, arr in ck["body_params"].items():
                    if k not in system.body_params:
                        continue
                    p = system.body_params[k]
                    if tuple(arr.shape) != tuple(p.shape):
                        raise ValueError(
                            f"body_params:{k} shape {arr.shape} != target "
                            f"{tuple(p.shape)}")
                    p.copy_(torch.from_numpy(arr))
        elif group == "latent_codes" and "latent_codes" in ck \
                and system.latent_codes is not None:
            arr = ck["latent_codes"]
            if tuple(arr.shape) != tuple(system.latent_codes.shape):
                raise ValueError(
                    f"latent_codes shape {arr.shape} != target "
                    f"{tuple(system.latent_codes.shape)}")
            with torch.no_grad():
                system.latent_codes.copy_(torch.from_numpy(arr))


def save_train_state(path: str, system, optimizer, scheduler, step: int,
                     generator: Optional[torch.Generator] = None,
                     metadata: Optional[dict] = None) -> None:
    """The full training state: the parameter groups, meta.json with the
    step, and ``opt_state.pt`` (optimizer, scheduler, noise generator)."""
    meta = dict(metadata or {})
    meta["step"] = int(step)
    save_params(path, system_params(system), meta)
    torch.save({
        "optimizer": optimizer.state_dict(),
        "scheduler": None if scheduler is None else scheduler.state_dict(),
        "generator": None if generator is None else generator.get_state(),
    }, os.path.join(path, OPT_STATE))


def load_train_state(path: str, system, optimizer, scheduler,
                     generator: Optional[torch.Generator] = None) -> int:
    """Restore ``save_train_state``'s state -> the step. A checkpoint
    without ``opt_state.pt`` (the JAX package's) restores its parameters
    and step; the optimizer stays fresh, and a line says so."""
    load_params(path, system)
    step = int(load_metadata(path).get("step", 0))
    file = os.path.join(path, OPT_STATE)
    if not os.path.exists(file):
        print(f"{path}: no {OPT_STATE} (a JAX package checkpoint): "
              f"resuming its parameters at step {step} with a fresh "
              "optimizer", flush=True)
        return step
    state = torch.load(file, map_location="cpu", weights_only=True)
    optimizer.load_state_dict(state["optimizer"])
    if scheduler is not None and state["scheduler"] is not None:
        scheduler.load_state_dict(state["scheduler"])
    if generator is not None and state["generator"] is not None:
        generator.set_state(state["generator"])
    return step


class CheckpointManager:
    """Top-k retention keyed on a monitored metric, as the JAX package's
    manager; 'last' is ``save_train_state``'s (the JAX loop writes it
    with the full train state whatever ``save_last`` says)."""

    def __init__(self, directory: str, monitor: str = "psnr",
                 mode: str = "max", save_top_k: int = 1):
        self.dir = directory
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self._best: list = []
        os.makedirs(directory, exist_ok=True)

    def _better(self, a: float, b: float) -> bool:
        return a > b if self.mode == "max" else a < b

    def save(self, params: dict, step: int, metrics: dict,
             extra_meta: Optional[dict] = None) -> Optional[str]:
        """params as ``system_params`` returns them -> the path of a new
        top-k checkpoint, or None."""
        value = float(metrics.get(self.monitor, np.nan))
        meta = {"step": step,
                "metrics": {k: float(v) for k, v in metrics.items()}}
        meta.update(extra_meta or {})
        if np.isnan(value):
            return None
        if len(self._best) < self.save_top_k or self._better(
                value, self._best[-1][0]):
            path = os.path.join(self.dir, f"step{step:08d}")
            save_params(path, params, meta)
            self._best.append((value, path))
            self._best.sort(key=lambda t: t[0], reverse=(self.mode == "max"))
            while len(self._best) > self.save_top_k:
                _, stale = self._best.pop()
                shutil.rmtree(stale, ignore_errors=True)
            return path
        return None

    @property
    def best_path(self) -> Optional[str]:
        return self._best[0][1] if self._best else None
