"""The sharded training and evaluation steps — counterpart of
``animnerf_tpu/parallel/train_pjit.py``, with its names.

Each returns JAX's ``(step, place_state, place_batch)``. The parameters
live in the system, so here ``step(batch, noise=None) -> details`` is the
trainer's step (``step.__self__`` is the trainer: its generator and step
count go into checkpoints), ``place_state(system)`` broadcasts the
parameters and buffers from the mesh's rank 0, and
``place_batch(host_batch)`` keeps this rank's rows of the global numpy
batch before the copy to the device. Every rank runs the whole one-process
step, kernels included, on its shard; only the gradients, the details and
the survivor count cross ranks (``training/system.py``).
"""

from __future__ import annotations

import functools
from typing import Optional

from animnerf_tpu_torch.parallel.mesh import (
    RAY_KEYS,
    Mesh,
    broadcast_,
    gather_rays,
    pad_rays_for_mesh,
    shard_batch,
    to_device,
)
from animnerf_tpu_torch.system import AnimNeRFSystem
from animnerf_tpu_torch.training.system import (
    DenseTrainer,
    make_eval_step,
    make_trainer,
)


def placement(mesh: Mesh):
    """(place_state, place_batch) of the mesh."""

    def place_state(system: AnimNeRFSystem) -> AnimNeRFSystem:
        broadcast_(mesh, list(system.parameters()) + list(system.buffers()))
        return system

    return place_state, functools.partial(shard_batch, mesh)


def make_sharded_train_step(system: AnimNeRFSystem, optimizer, scheduler,
                            mesh: Mesh, seed: int = 0):
    """The dense engine (``DenseTrainer``, JAX ``make_train_step``) over
    the mesh -> (step, place_state, place_batch)."""
    trainer = DenseTrainer(system, optimizer=optimizer, scheduler=scheduler,
                           seed=seed, mesh=mesh)
    return (trainer.step, *placement(mesh))


def make_sharded_trainer(system: AnimNeRFSystem, optimizer, scheduler,
                         mesh: Mesh, engine: Optional[str] = None,
                         seed: int = 0):
    """The engine ``make_trainer`` picks (``engine``, else
    ``ANIMNERF_TRAINER``, else ``auto``: rows-compacted for the flagship,
    dense for every other configuration) over the mesh, with the engine
    line printed by the mesh's rank 0 -> (step, place_state,
    place_batch)."""
    trainer = make_trainer(system, optimizer=optimizer, scheduler=scheduler,
                           seed=seed, engine=engine, mesh=mesh)
    if mesh.is_main:
        print(f"trainer engine: {trainer.engine} "
              f"(compute_dtype={system.scene_cfg.compute_dtype}, "
              f"remat={system.scene_cfg.remat}, "
              f"device={mesh.device.type}, mesh={mesh.size}dev, "
              f"backend={mesh.backend or 'none'})",
              flush=True)
    return (trainer.step, *placement(mesh))


def make_sharded_eval_step(system: AnimNeRFSystem, mesh: Mesh):
    """Full-frame rendering with the ray axis split over the mesh:
    eval_step(host_batch) -> the outputs of ``make_eval_step`` as (B, R, C)
    tensors on every rank. The rays (and ``rgbs`` / ``alphas``) are padded
    to a multiple of the mesh size by repeating the last ray, each rank
    renders its contiguous shard, and the shards are gathered and the
    padding trimmed. JAX's per-structure ``jit`` cache (``_cache``) has no
    counterpart: nothing is compiled."""
    step = make_eval_step(system)

    def eval_step(batch: dict) -> dict:
        if mesh.size == 1:
            return step(to_device(batch, mesh.device))
        n = batch["rays"].shape[1]
        padded = {k: pad_rays_for_mesh(v, mesh)[0]
                  if k in RAY_KEYS and v.ndim >= 2 else v
                  for k, v in batch.items()}
        out = step(shard_batch(mesh, padded, axis="rays"))
        return {k: gather_rays(mesh, v, n) for k, v in out.items()}

    return eval_step
