"""Training and evaluation steps — counterpart of
``animnerf_tpu/training/system.py`` (``psnr``, ``_safe_normalize``,
``compute_loss``, ``loss_fn`` and ``make_train_step`` (here
``DenseTrainer``), ``compact_loss_fn``, ``rows_compact_loss_fn``,
``make_optimizer``, ``CompactTrainer``, ``RowsCompactTrainer``,
``make_eval_step``, ``compaction_applicable``,
``rows_compaction_applicable``).

Three engines (``make_trainer``). ``auto`` picks as the JAX package's
``auto`` picks (``parallel/train_pjit.py``): the rows-compacted step for
the flagship configuration (``rows_compaction_applicable``), the dense
step (``loss_fn``: ``AnimNeRFSystem.render`` with perturb 1, through
``render_rays_split`` for view directions, latent codes, DeRF,
depth-guided samples, no unposing or more than 128 samples a ray) for
every other. ``compact`` is the opt-in point-major compacted step
(``compact_loss_fn``: the dense kNN's nearest distance selects the coarse
survivors, the blend and coarse MLP run on them alone,
``render/compact.py::render_rays_compact``); the environment variable
``ANIMNERF_TRAINER`` names the engine when the caller does not.

The JAX functions take a params pytree; here the parameters live in the
``AnimNeRFSystem`` (``system.py``), so the functions take the system.
The step: body model for the observed and template params, the Morton
vertex order, ``render_rays_rows_compact`` (box pre-pass, Morton-ordered
compaction, kNN with the tile skip, warp-blend, fused MLP, lane
merge-sort, composites), the six-term loss (rgb, alpha L1, fg/bg sigma
regularisers, normal smoothness through the plain MLP's input gradient;
each also on the fine field) and its backward, which runs the backward
kernels of the fused MLP and the warp-blend.

Spans (``utils/trace.py``): ``train.step`` around each trainer's step,
inside it ``train.forward`` (the loss function), ``train.backward`` (the
backward and, under a mesh, the gradients' all-reduce) and
``train.optimizer`` (the optimizer's and the scheduler's steps); ``loss``
around ``compute_loss``.

The JAX trainer's capacity ladder, overflow re-runs and pipelined count
polling (``CompactTrainer.step``) exist because XLA compiles static
shapes. Eager PyTorch sizes the compaction from the exact survivor count,
read once per step, so the step never overflows; ``compact_count`` is
still reported, and the point-major engine reports ``compact_overflow``
as 0, as its JAX twin's details carry it. The ladder's and the polling's
settings (JAX's ``quantum``, ``factor``, ``pipelined``, ``sync_every``,
``margin``) have no counterpart.

Every trainer takes a ``parallel/mesh.py::Mesh`` (JAX: ``mesh=`` of
``make_rows_compact_trainer``, ``training/system.py:617-704``). Under a
mesh of more than one rank each rank takes its rows of the global batch
(``parallel/train_pjit.py``'s ``place_batch``), draws the noise of the
whole batch from its generator (every rank the same, so a rank's noise is
the same rows of the one-process draw and the generators stay equal) and
keeps its rows, then after the backward the gradients are averaged in one
all-reduce (JAX's ``pmean``), the details in another and ``compact_count``
takes the maximum over ranks (JAX's ``pmax``). Survivor selection stays
exact on each shard. Without a mesh, or with a mesh of one, the step is
the one-process step.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from animnerf_tpu_torch.models.body_params import (
    batch_params_from_data,
    lookup_body_params,
)
from animnerf_tpu_torch.models.warp import prepare_frame, rays_to_root_frame
from animnerf_tpu_torch.ops.knn import keep_rows_within_boxes
from animnerf_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_grads,
    reduce_details,
    shard_noise,
)
from animnerf_tpu_torch.render.compact import render_rays_compact
from animnerf_tpu_torch.render.compact_rows import render_rays_rows_compact
from animnerf_tpu_torch.system import AnimNeRFSystem
from animnerf_tpu_torch.utils import trace
from animnerf_tpu_torch.utils.device import pin_fp32_geometry
from animnerf_tpu_torch.utils.rng import TrainNoise, draw_noise


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-10))


def _safe_normalize(n: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """n / (|n| + eps) with a finite gradient at n == 0."""
    norm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)
    return n / (norm + eps)


def compute_loss(system: AnimNeRFSystem, results: dict, rgbs: torch.Tensor,
                 alphas: torch.Tensor, ctx, noise: TrainNoise,
                 fg_points: Optional[torch.Tensor] = None,
                 bg_points: Optional[torch.Tensor] = None,
                 frame_idx: Optional[torch.Tensor] = None):
    """Six-term loss (reference train.py:228-322) -> (loss, details). The
    density terms take the frames' deformation code; without unposing the
    fg/bg terms are left out, as in the JAX package."""
    with trace.span("loss"):
        return _compute_loss(system, results, rgbs, alphas, ctx, noise,
                             fg_points, bg_points, frame_idx)


def _compute_loss(system, results, rgbs, alphas, ctx, noise, fg_points,
                  bg_points, frame_idx):
    t = system.train_cfg
    scene = system.scene
    has_fine = system.renderer_cfg.n_fine > 0 \
        and not system.scene_cfg.share_fine
    fields = [False, True] if has_fine else [False]
    d_code, _ = system.codes(frame_idx)

    details = {}
    loss = torch.mean((results["rgbs"] - rgbs) ** 2)
    details["loss_rgb"] = loss
    if has_fine:
        lf = torch.mean((results["rgbs_fine"] - rgbs) ** 2)
        details["loss_rgb_fine"] = lf
        loss = loss + lf

    la = torch.mean(torch.abs(results["alphas"] - alphas))
    details["loss_alphas"] = la
    loss = loss + t["lambda_alphas"] * la
    if has_fine:
        laf = torch.mean(torch.abs(results["alphas_fine"] - alphas))
        details["loss_alphas_fine"] = laf
        loss = loss + t["lambda_alphas"] * laf

    # fg/bg sigma terms: one MLP pass per field over both point sets
    scale = 2.0 / system.renderer_cfg.n_coarse
    if system.scene_cfg.use_unpose and (fg_points is not None
                                        or bg_points is not None):
        pts = torch.cat([p for p in (fg_points, bg_points) if p is not None],
                        dim=1)
        n_fg = fg_points.shape[1] if fg_points is not None else 0
        for fine in fields:
            e = torch.exp(-scale * torch.relu(
                scene.query_sigma(pts, fine, d_code)))
            sfx = "_fine" if fine else ""
            if fg_points is not None:
                lfg = torch.mean(e[:, :n_fg])
                details["loss_foreground" + sfx] = lfg
                loss = loss + t["lambda_foreground"] * lfg
            if bg_points is not None:
                lbg = torch.mean(1.0 - e[:, n_fg:])
                details["loss_background" + sfx] = lbg
                loss = loss + t["lambda_background"] * lbg

    # normal smoothness on jittered template vertices (train.py:288-309)
    pts = ctx.verts_template.detach() + noise.normal_pts * (
        system.scene_cfg.dis_threshold * 0.5)
    nbrs = pts + noise.normal_nbr * t["epsilon"]
    n_pts = pts.shape[1]
    pts_nrm = torch.cat([pts, nbrs], dim=1)
    for fine in fields:
        nrm = scene.query_normal(pts_nrm, fine, d_code)
        n1 = _safe_normalize(nrm[:, :n_pts])
        n2 = _safe_normalize(nrm[:, n_pts:])
        ln = torch.mean((n1 - n2) ** 2)
        details["loss_normals" + ("_fine" if fine else "")] = ln
        loss = loss + t["lambda_normals"] * ln

    details["loss"] = loss
    return loss, details


def _body_params(system: AnimNeRFSystem, batch: dict):
    if system.optim_body_params:
        body_params = lookup_body_params(dict(system.body_params),
                                         batch["frame_idx"])
    else:
        body_params = batch_params_from_data(batch, system.model_type)
    return body_params, batch_params_from_data(batch, system.model_type,
                                               template=True)


def rows_compact_loss_fn(system: AnimNeRFSystem, batch: dict,
                         noise: TrainNoise):
    """The training loss on the rows-native compacted kernel pipeline with
    Morton-ordered survivors -> (loss, details); details carry the psnr
    and ``compact_count`` (an int: the largest per-row coarse survivor
    count). batch: tensors on the system's device (``frame_idx``, ``rays``
    (B, R, 8), ``rgbs``, ``alphas``, the ``*_template`` body params, and
    optionally ``fg_points`` / ``bg_points`` and observed body params)."""
    frame_idx = batch["frame_idx"]
    body_params, body_tmpl = _body_params(system, batch)
    ctx = prepare_frame(system.body_model, body_params, body_tmpl)
    rays_root = rays_to_root_frame(ctx, batch["rays"])
    thr = system.scene_cfg.dis_threshold
    scene = system.scene
    results, n_c = render_rays_rows_compact(
        system.renderer_cfg,
        lambda rows: scene.warp_rows(ctx, rows, tile_skip=True),
        scene.field_rows, rays_root,
        lambda rows: keep_rows_within_boxes(rows, ctx.verts_morton, thr),
        noise=noise)
    loss, details = compute_loss(
        system, results, batch["rgbs"], batch["alphas"], ctx, noise,
        fg_points=batch.get("fg_points"), bg_points=batch.get("bg_points"),
        frame_idx=frame_idx)
    rgb_key = "rgbs_fine" if "rgbs_fine" in results else "rgbs"
    details["psnr"] = psnr(results[rgb_key], batch["rgbs"])
    details["compact_count"] = n_c
    return loss, details


def compact_loss_fn(system: AnimNeRFSystem, batch: dict, noise: TrainNoise):
    """The training loss on the point-major compacted render (JAX
    ``AnimNeRFSystem.compact_loss_fn``) -> (loss, details): the dense kNN
    of the coarse samples against the observed mesh-order verts
    (``AnimNeRFModel.warp_knn``), the blend (``warp_points_with_knn``) and
    the coarse field on the survivors of ``dists[..., 0] <
    dis_threshold``, a dense fine pass (``render_rays_compact``), then
    ``compute_loss``. details carry the psnr, ``compact_count`` (an int:
    the largest per-row count of coarse survivors) and
    ``compact_overflow`` (always 0: every survivor is selected). batch as
    ``rows_compact_loss_fn`` takes it."""
    frame_idx = batch["frame_idx"]
    body_params, body_tmpl = _body_params(system, batch)
    ctx = prepare_frame(system.body_model, body_params, body_tmpl)
    rays_root = rays_to_root_frame(ctx, batch["rays"])
    d_code, a_code = system.codes(frame_idx)
    scene = system.scene

    def field_fn(xyz, viewdir, valid, use_fine):
        return scene.field_points(xyz, viewdir, valid, use_fine, d_code,
                                  a_code)

    results, count = render_rays_compact(
        system.renderer_cfg,
        lambda xyz, viewdir: scene.warp_points(ctx, xyz, viewdir),
        field_fn, rays_root, lambda xyz: scene.warp_knn(ctx, xyz),
        lambda xyz, viewdir, dists, idx: scene.warp_points_with_knn(
            ctx, xyz, viewdir, dists, idx),
        system.scene_cfg.dis_threshold, perturb=1.0, noise=noise)
    loss, details = compute_loss(
        system, results, batch["rgbs"], batch["alphas"], ctx, noise,
        fg_points=batch.get("fg_points"), bg_points=batch.get("bg_points"),
        frame_idx=frame_idx)
    rgb_key = "rgbs_fine" if "rgbs_fine" in results else "rgbs"
    details["psnr"] = psnr(results[rgb_key], batch["rgbs"])
    details["compact_count"] = count
    details["compact_overflow"] = 0
    return loss, details


def loss_fn(system: AnimNeRFSystem, batch: dict, noise: TrainNoise):
    """The dense training loss (JAX ``AnimNeRFSystem.loss_fn``): the
    batch rendered by ``AnimNeRFSystem.render`` at perturb 1 with the
    frames' codes and ``noise``, then ``compute_loss`` -> (loss, details
    with the psnr). batch as ``rows_compact_loss_fn`` takes it."""
    frame_idx = batch["frame_idx"]
    body_params, body_tmpl = _body_params(system, batch)
    results, ctx = system.render(body_params, body_tmpl, batch["rays"],
                                 frame_idx, perturb=1.0, noise=noise)
    loss, details = compute_loss(
        system, results, batch["rgbs"], batch["alphas"], ctx, noise,
        fg_points=batch.get("fg_points"), bg_points=batch.get("bg_points"),
        frame_idx=frame_idx)
    rgb_key = "rgbs_fine" if "rgbs_fine" in results else "rgbs"
    details["psnr"] = psnr(results[rgb_key], batch["rgbs"])
    return loss, details


def compaction_applicable(system: AnimNeRFSystem) -> bool:
    """Sample compaction is exact for the kNN-unposed field without DeRF,
    latent codes or depth-guided samples (JAX
    ``AnimNeRFSystem.compaction_applicable``)."""
    sc = system.scene_cfg
    return (sc.use_unpose and not sc.use_deformation
            and sc.deformation_dim == 0 and sc.apperance_dim == 0
            and system.renderer_cfg.n_fine_depth == 0)


def rows_compaction_applicable(system: AnimNeRFSystem) -> bool:
    """The rows-compacted step needs the rows pipeline and compaction."""
    return compaction_applicable(system) and system.rows_renderable()


def _schedule(t: dict, base_lr: float, steps_per_epoch: int):
    """Per-epoch LR factor of update ``step`` (reference
    utils/__init__.py:46-58): poly (1 - e/E)^exp, steplr multi-step decay,
    cosine annealing; as a factor of base_lr for ``LambdaLR``."""
    sched = t["scheduler"]
    stype = sched.get("type", "poly")
    spe = max(steps_per_epoch, 1)

    def factor(step: int) -> float:
        epoch = step // spe
        if stype == "steplr":
            n = sum(epoch >= d for d in sched.get("decay_step", [20]))
            return sched.get("decay_gamma", 0.1) ** n
        if stype == "cosine":
            frac = min(max(epoch / t["max_epochs"], 0.0), 1.0)
            eps = 1e-8
            lr = eps + (base_lr - eps) * 0.5 * (1.0 + math.cos(math.pi * frac))
            return lr / base_lr
        return max(1.0 - epoch / t["max_epochs"], 0.0) ** sched["poly_exp"]

    return factor


def make_optimizer(system: AnimNeRFSystem, steps_per_epoch: int,
                   train_field: bool = True):
    """(optimizer, scheduler): the field at lr, the latent codes at lr
    (trained even when a loaded field is frozen, as the JAX package's
    ``latent`` group) and the body params at half of it, Adam (eps 1e-8;
    AdamW with weight_decay) or SGD with momentum, and the per-epoch
    schedule applied per update (step the scheduler after every optimizer
    step, as optax counts updates)."""
    t = system.train_cfg
    lr = float(t["lr"])
    groups = []
    if train_field:
        groups.append({"params": list(system.scene.parameters()), "lr": lr})
    if system.latent_codes is not None:
        groups.append({"params": [system.latent_codes], "lr": lr})
    if system.optim_body_params:
        groups.append({"params": list(system.body_params.parameters()),
                       "lr": 0.5 * lr})
    opt = t["optimizer"]
    wd = float(opt.get("weight_decay", 0) or 0)
    if opt["type"] == "sgd":
        optimizer = torch.optim.SGD(groups, lr=lr,
                                    momentum=float(opt["momentum"]))
    elif wd > 0:
        optimizer = torch.optim.AdamW(groups, lr=lr, eps=1e-8,
                                      weight_decay=wd)
    else:
        optimizer = torch.optim.Adam(groups, lr=lr, eps=1e-8)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, [_schedule(t, g["lr"], steps_per_epoch) for g in groups])
    return optimizer, scheduler


class RowsCompactTrainer:
    """One training step: noise from the trainer's generator (or given),
    the rows-compacted loss, its backward, the optimizer and scheduler
    steps. Exact survivor selection: no capacity, no re-run. ``mesh``: the
    ranks that split each batch (see the module's docstring)."""

    engine = "rows"
    loss_fn = staticmethod(rows_compact_loss_fn)

    def __init__(self, system: AnimNeRFSystem, steps_per_epoch: int = 100,
                 optimizer=None, scheduler=None, seed: int = 0,
                 mesh: Optional[Mesh] = None):
        pin_fp32_geometry()
        self.system = system
        if optimizer is None:
            optimizer, scheduler = make_optimizer(system, steps_per_epoch)
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.generator = torch.Generator(device=system.device)
        self.generator.manual_seed(seed)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.steps = 0

    def draw_noise(self, batch: dict) -> TrainNoise:
        """The noise of the global batch: this rank's rows times the mesh
        size."""
        B, R = batch["rays"].shape[:2]
        if self.mesh is not None:
            B *= self.mesh.size
        return draw_noise(self.generator, B, R, self.system.renderer_cfg,
                          self.system.body_model.num_verts)

    def step(self, batch: dict, noise: Optional[TrainNoise] = None) -> dict:
        """batch as ``rows_compact_loss_fn`` takes it (under a mesh: this
        rank's rows) -> details (0-d tensors; the rows engine's
        ``compact_count`` an int). ``noise``: the global batch's (drawn
        from the trainer's generator when None)."""
        with trace.span("train.step", root=True):
            if noise is None:
                noise = self.draw_noise(batch)
            if self.mesh is not None:
                noise = shard_noise(self.mesh, noise)
            self.optimizer.zero_grad(set_to_none=True)
            with trace.span("train.forward"):
                loss, details = self.loss_fn(self.system, batch, noise)
            with trace.span("train.backward"):
                loss.backward()
                if self.mesh is not None:
                    all_reduce_grads(self.mesh, [
                        p for g in self.optimizer.param_groups
                        for p in g["params"]])
                    details = reduce_details(self.mesh, details)
            with trace.span("train.optimizer"):
                self.optimizer.step()
                if self.scheduler is not None:
                    self.scheduler.step()
            self.steps += 1
            return {k: v.detach() if torch.is_tensor(v) else v
                    for k, v in details.items()}


class DenseTrainer(RowsCompactTrainer):
    """The dense engine (JAX ``make_train_step``): the same step on the
    dense ``loss_fn``."""

    engine = "dense"
    loss_fn = staticmethod(loss_fn)


class CompactTrainer(RowsCompactTrainer):
    """The opt-in point-major compacted engine (JAX ``CompactTrainer``):
    the same step on ``compact_loss_fn``, for configurations where
    ``compaction_applicable`` (ValueError otherwise, as in JAX). Its
    survivors are selected exactly, so a step never overflows and is
    never re-run: no capacity ladder, no pipelined count polling."""

    engine = "compact"
    loss_fn = staticmethod(compact_loss_fn)

    def __init__(self, system: AnimNeRFSystem, *args, **kwargs):
        if not compaction_applicable(system):
            raise ValueError(
                "compacted training requires use_unpose and no "
                "deformation/latent codes (see compaction_applicable)")
        super().__init__(system, *args, **kwargs)


ENGINES = {"rows": RowsCompactTrainer, "compact": CompactTrainer,
           "dense": DenseTrainer}


def make_trainer(system: AnimNeRFSystem, steps_per_epoch: int = 100,
                 optimizer=None, scheduler=None, seed: int = 0,
                 engine: Optional[str] = None, mesh: Optional[Mesh] = None):
    """A trainer of the named engine: "rows", "compact", "dense" or
    "auto"; None reads ``ANIMNERF_TRAINER`` (default "auto"), as the JAX
    package's ``make_sharded_trainer`` does. "auto" is rows-compacted where
    ``rows_compaction_applicable``, else dense. "rows" and "compact" raise
    ValueError on a configuration they do not cover. ``mesh``: the ranks
    that split each batch."""
    if engine is None:
        engine = os.environ.get("ANIMNERF_TRAINER", "auto")
    if engine == "auto":
        engine = "rows" if rows_compaction_applicable(system) else "dense"
    if engine not in ENGINES:
        raise ValueError(f"unknown trainer engine {engine!r}: use auto, "
                         f"{', '.join(ENGINES)}")
    if engine == "rows" and not rows_compaction_applicable(system):
        raise ValueError("the rows engine needs the rows pipeline and "
                         "compaction (see rows_compaction_applicable)")
    return ENGINES[engine](system, steps_per_epoch, optimizer, scheduler,
                           seed, mesh=mesh)


def make_eval_step(system: AnimNeRFSystem):
    """The evaluation step: eval_step(batch) -> the dense render's outputs
    (``AnimNeRFSystem.render`` with the frames' codes, perturb 0, no
    gradient). batch: tensors on the system's device (``frame_idx`` (B,),
    ``rays`` (B, R, 8), the ``*_template`` body params and the observed
    ones). With body params
    optimised, a frame of the training set (frame_idx >= 0) takes its
    stored params and any other (frame_idx == -1) the batch's, blended as
    sel * stored + (1 - sel) * given as the JAX step does."""

    def eval_step(batch: dict) -> dict:
        with torch.no_grad():
            frame_idx = batch["frame_idx"]
            given = batch_params_from_data(batch, system.model_type)
            if system.optim_body_params:
                stored = lookup_body_params(dict(system.body_params),
                                            frame_idx)
                sel = (frame_idx >= 0).to(torch.float32)
                body_params = {}
                for k, v in stored.items():
                    s = sel.reshape((-1,) + (1,) * (v.ndim - 1))
                    body_params[k] = s * v + (1 - s) * given[k]
            else:
                body_params = given
            body_tmpl = batch_params_from_data(batch, system.model_type,
                                               template=True)
            results, _ = system.render(body_params, body_tmpl, batch["rays"],
                                       frame_idx)
        return results

    return eval_step
