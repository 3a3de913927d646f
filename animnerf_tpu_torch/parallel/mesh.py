"""The data-parallel mesh on ``torch.distributed`` — counterpart of
``animnerf_tpu/parallel/mesh.py``.

The JAX package scales through one ``jax.sharding.Mesh`` whose ``"data"``
axis splits the rays: training batches along their leading batch axis,
full-frame renders along the ray axis, parameters replicated. Here the
mesh is a group of processes, one per GPU (NCCL), or on the CPU (gloo).
Every process holds the whole model; a ``Mesh`` names the process group,
this process's rank in it, its size and the rank's ``torch.device``.
Batches split into equal contiguous shards, one per rank; the gradient
and the step's details cross ranks in explicit all-reduces
(``all_reduce_grads``, ``reduce_details``), as JAX's ``shard_map`` with
``pmean``.

Both backends take the rank's device tensors in every collective here:
NCCL on the card, gloo on the CPU and, with two ranks sharing one card,
on CUDA tensors too (PyTorch 2.11).

``init_distributed`` is the start-up from torchrun's environment (JAX:
``jax.distributed.initialize`` under ``ANIMNERF_MULTIHOST``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from animnerf_tpu_torch.utils.device import DeviceLike, resolve_device
from animnerf_tpu_torch.utils.rng import TrainNoise

# the per-ray arrays of a render batch, sharded along their ray axis
RAY_KEYS = ("rays", "rgbs", "alphas")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A group of ranks that split each batch. ``group`` None: one
    process without a process group. ``rank`` -1: this process is outside
    the group (an idle rank of ``mesh_for_batch``). ``src`` is the global
    rank of the mesh's rank 0, the source of broadcasts."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    src: int = 0
    backend: Optional[str] = None

    @property
    def active(self) -> bool:
        return self.rank >= 0

    @property
    def is_main(self) -> bool:
        """The rank that writes checkpoints, logs, images and scores."""
        return self.rank == 0


def _rank_device(device: DeviceLike) -> torch.device:
    """The rank's device: NCCL's is the current CUDA device (torchrun's
    LOCAL_RANK, set by ``init_distributed``); otherwise ``device`` as the
    entry points resolve it."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, group=None,
              device: DeviceLike = None) -> Mesh:
    """The mesh over the first ``n_devices`` ranks of the world (all by
    default), or over ``group``. Without a process group: a mesh of one.
    A mesh over part of the world makes a new group, which every rank of
    the world must call ``make_mesh`` for (``torch.distributed.new_group``);
    the ranks outside it get an inactive mesh."""
    dev = _rank_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1) or group is not None:
            raise ValueError("a mesh over several devices needs a process "
                             "group: start with torchrun or call "
                             "init_distributed()")
        return Mesh(None, 0, 1, dev)
    if group is None:
        world = dist.get_world_size()
        n = world if n_devices is None else int(n_devices)
        if not 1 <= n <= world:
            raise ValueError(f"n_devices {n}: the world has {world} ranks")
        ranks = list(range(n))
        group = dist.group.WORLD if n == world else dist.new_group(ranks)
    else:
        ranks = dist.get_process_group_ranks(group)
    me = dist.get_rank()
    if me not in ranks:
        return Mesh(None, -1, len(ranks), dev, src=ranks[0])
    return Mesh(group, ranks.index(me), len(ranks), dev, src=ranks[0],
                backend=dist.get_backend(group))


def mesh_for_batch(batch_size: int, device: DeviceLike = None) -> Mesh:
    """The largest mesh whose size divides the batch (a 2-sample batch on
    3 ranks trains on 2; the third rank's mesh is inactive)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    while n > 1 and batch_size % n != 0:
        n -= 1
    return make_mesh(n, device=device)


def barrier(mesh: Optional[Mesh] = None) -> None:
    """Wait for every rank of the mesh (of the world with None); nothing
    without a process group."""
    if not dist.is_initialized() or (mesh is not None
                                     and mesh.group is None):
        return
    group = None if mesh is None else mesh.group
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


# ------------------------------------------------------------ collectives

def all_reduce_(mesh: Mesh, t: torch.Tensor,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over the mesh."""
    if mesh.group is not None:
        dist.all_reduce(t, op=op, group=mesh.group)
    return t


def all_reduce_grads(mesh: Mesh, params: Iterable[torch.Tensor]) -> int:
    """The mean gradient over the mesh, in place: one SUM all-reduce of a
    flat float32 buffer (every parameter's gradient in the given order,
    zeros for a gradient that is None here, then one presence flag per
    parameter), divided by the mesh size. A gradient that is None on every
    rank stays None. -> the bytes reduced."""
    params = list(params)
    if mesh.group is None or not params:
        return 0
    dev = params[0].device
    parts = [(p.grad if p.grad is not None else torch.zeros_like(p))
             .reshape(-1).float() for p in params]
    parts.append(torch.tensor([float(p.grad is not None) for p in params],
                              device=dev))
    flat = torch.cat(parts)
    all_reduce_(mesh, flat)
    n = flat.numel() - len(params)
    flat[:n].div_(mesh.size)
    present = flat[n:].cpu() > 0
    off = 0
    for p, has in zip(params, present.tolist()):
        g = flat[off:off + p.numel()].view_as(p).to(p.dtype)
        off += p.numel()
        if has:
            p.grad = g.clone() if p.grad is None else p.grad.copy_(g)
    return flat.numel() * flat.element_size()


def reduce_details(mesh: Mesh, details: dict) -> dict:
    """The step's details over the mesh: the tensors' mean (JAX's pmean
    of the details) in one all-reduce, the integer survivor counts
    (``compact_count``, ``compact_overflow``) their maximum (JAX's pmax)
    in another."""
    if mesh.group is None:
        return details
    means = sorted(k for k, v in details.items() if torch.is_tensor(v))
    maxes = sorted(k for k in details if k not in means)
    out = {}
    if means:
        vals = torch.stack([details[k].detach().float().reshape(())
                            for k in means])
        all_reduce_(mesh, vals).div_(mesh.size)
        out.update({k: vals[i].to(details[k].dtype)
                    for i, k in enumerate(means)})
    if maxes:
        vals = torch.tensor([int(details[k]) for k in maxes],
                            dtype=torch.int64, device=mesh.device)
        all_reduce_(mesh, vals, dist.ReduceOp.MAX)
        out.update({k: int(v) for k, v in zip(maxes, vals.tolist())})
    return out


def all_gather_cat(mesh: Mesh, t: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
    rank order, on every rank."""
    if mesh.group is None or mesh.size == 1:
        return t
    buf = t.detach().contiguous()
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    return torch.cat(parts, dim)


def broadcast_(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> None:
    """Copy the mesh's rank 0's values into ``tensors`` on every rank
    (through ``copy_``, so the parameters' version counters move and
    caches keyed on them, such as the MLP kernels' weight image, refresh)."""
    if mesh.group is None:
        return
    for t in tensors:
        buf = t.detach().clone()
        dist.broadcast(buf, src=mesh.src, group=mesh.group)
        with torch.no_grad():
            t.copy_(buf)


def broadcast_object(mesh: Mesh, obj):
    """The mesh's rank 0's picklable ``obj``, on every rank."""
    if mesh.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=mesh.src, group=mesh.group)
    return box[0]


# ----------------------------------------------------------------- shards

def shard_rows(mesh: Mesh, x, axis: int = 0):
    """This rank's contiguous 1/size of ``x`` (a tensor or a numpy array)
    along ``axis``, a view; the length must divide evenly."""
    n = x.shape[axis]
    if n % mesh.size:
        raise ValueError(f"axis {axis} of length {n} does not split over "
                         f"{mesh.size} ranks")
    m = n // mesh.size
    return x[(slice(None),) * axis + (slice(mesh.rank * m,
                                            (mesh.rank + 1) * m),)]


def shard_noise(mesh: Mesh, noise: TrainNoise) -> TrainNoise:
    """This rank's rows of a global batch's noise (every field of
    ``TrainNoise``, the (B, V, 3) normal-loss jitters included)."""
    return TrainNoise(**{
        f.name: None if getattr(noise, f.name) is None
        else shard_rows(mesh, getattr(noise, f.name))
        for f in dataclasses.fields(noise)})


def to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch -> tensors on the device (pinned host memory and a
    non-blocking copy on the card)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def shard_batch(mesh: Mesh, batch: dict, axis: str = "batch") -> dict:
    """A host (numpy) batch -> this rank's shard as tensors on its device.
    axis "batch": the training layout, every array's leading axis split
    (0-d arrays whole); "rays": the render layout, the ray axis (axis 1)
    of ``rays`` / ``rgbs`` / ``alphas`` split and every other array
    whole."""
    if axis not in ("batch", "rays"):
        raise ValueError(f"axis {axis!r}: 'batch' or 'rays'")
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if axis == "batch" and v.ndim >= 1:
            v = shard_rows(mesh, v, 0)
        elif axis == "rays" and k in RAY_KEYS and v.ndim >= 2:
            v = shard_rows(mesh, v, 1)
        out[k] = v
    return to_device(out, mesh.device)


def pad_rays_for_mesh(rays, mesh: Mesh):
    """Pad the ray axis (axis 1) of a numpy array or a tensor to a
    multiple of the mesh size by repeating the last ray -> (rays, the
    unpadded length)."""
    n = rays.shape[1]
    pad = (-n) % mesh.size
    if pad:
        idx = np.minimum(np.arange(n + pad), n - 1)
        rays = (rays.index_select(1, torch.from_numpy(idx).to(rays.device))
                if torch.is_tensor(rays) else rays[:, idx])
    return rays, n


def gather_rays(mesh: Mesh, t: torch.Tensor, n: int,
                dim: int = 1) -> torch.Tensor:
    """Every rank's ray shard of ``t`` gathered along ``dim`` in rank
    order, the padding of ``pad_rays_for_mesh`` trimmed to ``n`` rays."""
    return all_gather_cat(mesh, t, dim).narrow(dim, 0, n)


def check_visible(mesh: Mesh, path: str) -> None:
    """Raise on every rank of the mesh together where some rank cannot
    see ``path``, a checkpoint that every rank loads (across hosts,
    ``checkpoints_dir`` must be a shared directory); nothing without a
    process group."""
    if mesh.group is None:
        return
    seen = torch.tensor([int(os.path.exists(path))], device=mesh.device)
    if int(all_reduce_(mesh, seen, dist.ReduceOp.MIN)) == 0:
        raise FileNotFoundError(
            f"{path}: not found on every rank; across hosts the "
            "checkpoints must be on a directory that every rank sees")


# --------------------------------------------------------------- start-up

def distributed_requested() -> bool:
    """torchrun started several ranks, or ``ANIMNERF_MULTIHOST`` asks for
    the process group anyway."""
    return (int(os.environ.get("WORLD_SIZE", "1")) > 1
            or bool(os.environ.get("ANIMNERF_MULTIHOST")))


def init_distributed(device: DeviceLike = None) -> torch.device:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) -> this rank's device. On the card (the default):
    NCCL on ``cuda:LOCAL_RANK``, and a RuntimeError where this PyTorch has
    no NCCL; ``device="cpu"``: gloo on the CPU."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_distributed: {', '.join(missing)} not "
                           "set; start the ranks with torchrun")
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        dist.init_process_group("gloo", init_method="env://", rank=rank,
                                world_size=world)
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or "
                         "'cpu'")
    if not dist.is_nccl_available():
        raise RuntimeError("this PyTorch has no NCCL; pass device='cpu' "
                           "for gloo on the CPU")
    resolve_device("cuda")
    dev = torch.device("cuda", local)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method="env://", rank=rank,
                            world_size=world, device_id=dev)
    return dev
