"""Training step of the flagship model — counterpart of
``animnerf_tpu/training/system.py`` (``psnr``, ``_safe_normalize``,
``compute_loss``, ``rows_compact_loss_fn``, ``make_optimizer``,
``RowsCompactTrainer``).

The JAX functions take a params pytree; here the parameters live in the
``AnimNeRFSystem`` (``system.py``), so the functions take the system.
The step: body model for the observed and template params, the Morton
vertex order, ``render_rays_rows_compact`` (box pre-pass, Morton-ordered
compaction, kNN with the tile skip, warp-blend, fused MLP, lane
merge-sort, composites), the six-term loss (rgb, alpha L1, fg/bg sigma
regularisers, normal smoothness through the plain MLP's input gradient;
each also on the fine field) and its backward, which runs the backward
kernels of the fused MLP and the warp-blend.

The JAX trainer's capacity ladder, overflow re-runs and pipelined count
polling (``CompactTrainer.step``) exist because XLA compiles static
shapes. Eager PyTorch sizes the compaction from the exact survivor count,
read once per step, so the step never overflows; ``compact_count`` is
still reported, ``compact_overflow`` is always 0 and is not.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from animnerf_tpu_torch.models.body_params import (
    batch_params_from_data,
    lookup_body_params,
)
from animnerf_tpu_torch.models.warp import prepare_frame, rays_to_root_frame
from animnerf_tpu_torch.ops.knn import keep_rows_within_boxes
from animnerf_tpu_torch.render.compact_rows import render_rays_rows_compact
from animnerf_tpu_torch.system import AnimNeRFSystem
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
                 bg_points: Optional[torch.Tensor] = None):
    """Six-term loss (reference train.py:228-322) -> (loss, details)."""
    t = system.train_cfg
    scene = system.scene
    has_fine = system.renderer_cfg.n_fine > 0 \
        and not system.scene_cfg.share_fine
    fields = [False, True] if has_fine else [False]

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
    if fg_points is not None or bg_points is not None:
        pts = torch.cat([p for p in (fg_points, bg_points) if p is not None],
                        dim=1)
        n_fg = fg_points.shape[1] if fg_points is not None else 0
        for fine in fields:
            e = torch.exp(-scale * torch.relu(scene.query_sigma(pts, fine)))
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
        nrm = scene.query_normal(pts_nrm, fine)
        n1 = _safe_normalize(nrm[:, :n_pts])
        n2 = _safe_normalize(nrm[:, n_pts:])
        ln = torch.mean((n1 - n2) ** 2)
        details["loss_normals" + ("_fine" if fine else "")] = ln
        loss = loss + t["lambda_normals"] * ln

    details["loss"] = loss
    return loss, details


def rows_compact_loss_fn(system: AnimNeRFSystem, batch: dict,
                         noise: TrainNoise):
    """The training loss on the rows-native compacted kernel pipeline with
    Morton-ordered survivors -> (loss, details); details carry the psnr
    and ``compact_count`` (an int: the largest per-row coarse survivor
    count). batch: tensors on the system's device (``frame_idx``, ``rays``
    (B, R, 8), ``rgbs``, ``alphas``, the ``*_template`` body params, and
    optionally ``fg_points`` / ``bg_points`` and observed body params)."""
    if system.scene_cfg.share_fine:
        raise NotImplementedError("share_fine training is not ported yet")
    frame_idx = batch["frame_idx"]
    if system.optim_body_params:
        body_params = lookup_body_params(dict(system.body_params), frame_idx)
    else:
        body_params = batch_params_from_data(batch, system.model_type)
    body_tmpl = batch_params_from_data(batch, system.model_type,
                                       template=True)
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
        fg_points=batch.get("fg_points"), bg_points=batch.get("bg_points"))
    rgb_key = "rgbs_fine" if "rgbs_fine" in results else "rgbs"
    details["psnr"] = psnr(results[rgb_key], batch["rgbs"])
    details["compact_count"] = n_c
    return loss, details


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
    """(optimizer, scheduler): the field at lr and the body params at half
    of it (latent codes would join the field's rate; the flagship has
    none), Adam (eps 1e-8; AdamW with weight_decay) or SGD with momentum,
    and the per-epoch schedule applied per update (step the scheduler
    after every optimizer step, as optax counts updates)."""
    t = system.train_cfg
    lr = float(t["lr"])
    groups = []
    if train_field:
        groups.append({"params": list(system.scene.parameters()), "lr": lr})
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
    steps. Exact survivor selection: no capacity, no re-run."""

    def __init__(self, system: AnimNeRFSystem, steps_per_epoch: int = 100,
                 optimizer=None, scheduler=None, seed: int = 0):
        pin_fp32_geometry()
        self.system = system
        if optimizer is None:
            optimizer, scheduler = make_optimizer(system, steps_per_epoch)
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.generator = torch.Generator(device=system.device)
        self.generator.manual_seed(seed)
        self.steps = 0

    def draw_noise(self, batch: dict) -> TrainNoise:
        B, R = batch["rays"].shape[:2]
        return draw_noise(self.generator, B, R, self.system.renderer_cfg,
                          self.system.body_model.num_verts)

    def step(self, batch: dict, noise: Optional[TrainNoise] = None) -> dict:
        """batch as ``rows_compact_loss_fn`` takes it -> details (0-d
        tensors, ``compact_count`` an int)."""
        if noise is None:
            noise = self.draw_noise(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss, details = rows_compact_loss_fn(self.system, batch, noise)
        loss.backward()
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.steps += 1
        return {k: v.detach() if torch.is_tensor(v) else v
                for k, v in details.items()}
