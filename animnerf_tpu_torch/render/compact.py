"""Sample-level compacted rendering, for inference and the point-major
compacted training step — counterpart of ``animnerf_tpu/render/compact.py``.

Most samples of a frame lie outside the ``dis_threshold`` shell around the
body, where the warp gives sigma == SIGMA_OUTSIDE and zero composite
weight; the kNN, warp-blend and MLP therefore run only on the survivors of
a conservative pre-pass, and their results are scattered back into the
dense (R, K) grid before compositing — exact end to end.
``render_rays_compact`` (the training step's) runs the kNN dense instead,
since its nearest distance is the exact validity test, and compacts only
the blend and the coarse MLP behind it.

The JAX package pads the survivor list to a static capacity rung (XLA
needs static shapes) and pads with the out-of-bounds index N. Eager
PyTorch has dynamic shapes: ``select_indices`` lists every survivor
exactly (``torch.nonzero``, flat order); only a batch of several rows pads
its shorter rows with N, which the gathers clamp and the scatters drop.

Spans (``utils/trace.py``): ``compact.prepass`` around the selection
(``select_indices``), ``composite`` around each pass's scatter into the
dense grid and its composite; the waits ``wait.survivors`` (the
selection's ``torch.nonzero``, its largest row count and its masked
writes) and ``wait.scatter`` (the scatters' masked reads and writes).
"""

from __future__ import annotations

from typing import Optional

import torch

from animnerf_tpu_torch.models.anim_nerf import SIGMA_OUTSIDE
from animnerf_tpu_torch.render.volume_renderer import (
    RendererConfig,
    _eval_field,
    _ray_points,
    _warp,
    composite,
    composite_rows,
    composite_weights,
    sample_coarse,
    sample_fine,
    sort_by_depth,
)
from animnerf_tpu_torch.utils import trace


def select_indices(keep: torch.Tensor,
                   cap: Optional[int] = None) -> torch.Tensor:
    """(B, N) bool -> (B, cap) int64 survivor indices in flat order, padded
    with N; cap defaults to the largest row count (no survivor dropped).
    With an explicit cap the result equals the JAX package's."""
    with trace.span("compact.prepass"):
        B, n = keep.shape
        counts = keep.sum(dim=1)
        with trace.wait("wait.survivors"):
            rows, cols = torch.nonzero(keep, as_tuple=True)  # row-major
            if cap is None:
                cap = int(counts.max()) if B else 0
        pos = torch.arange(len(rows), device=keep.device) \
            - (torch.cumsum(counts, 0) - counts)[rows]
        sel = torch.full((B, cap), n, dtype=torch.int64, device=keep.device)
        fits = pos < cap
        with trace.wait("wait.survivors"):
            sel[rows[fits], pos[fits]] = cols[fits]
        return sel


def _flat_scatter_indices(sel: torch.Tensor, n: int):
    """Row-offset sel into the flat (B*n,) grid; (flat, valid-mask)."""
    B = sel.shape[0]
    flat = sel + (torch.arange(B, device=sel.device) * n)[:, None]
    return flat.reshape(-1), (sel < n).reshape(-1)


def gather_samples(rays: torch.Tensor, z_flat: torch.Tensor,
                   sel: torch.Tensor, K: int):
    """rays (B, R, 8), z_flat (B, R*K), sel (B, cap) -> per-sample
    xyz (B, cap, 3), viewdir (B, cap, 3). Padded entries are clamped."""
    sel = torch.clamp_max(sel, z_flat.shape[1] - 1)
    ray_i = sel // K
    rays_sel = torch.gather(rays, 1, ray_i[..., None].expand(*ray_i.shape, 8))
    z_sel = torch.gather(z_flat, 1, sel)
    xyz = rays_sel[..., 0:3] + z_sel[..., None] * rays_sel[..., 3:6]
    return xyz, rays_sel[..., 3:6]


def _scatter_1d(vals: torch.Tensor, flat: torch.Tensor, ok: torch.Tensor,
                n: int, fill: float) -> torch.Tensor:
    base = torch.full((n,), fill, dtype=vals.dtype, device=vals.device)
    with trace.wait("wait.scatter"):
        base[flat[ok]] = vals[ok]
    return base


def scatter_dense(rgb: Optional[torch.Tensor], sigma: torch.Tensor,
                  sel: torch.Tensor, R: int, K: int):
    """Scatter compacted (B, cap, ...) rgb/sigma into dense (B, R, K[, 3])
    grids with the SIGMA_OUTSIDE / zero fill; rgb=None skips the rgb grid."""
    B = sel.shape[0]
    flat, ok = _flat_scatter_indices(sel, R * K)
    sigma_d = _scatter_1d(sigma.reshape(-1), flat, ok, B * R * K,
                          SIGMA_OUTSIDE).reshape(B, R, K)
    if rgb is None:
        return None, sigma_d
    rgb_d = torch.stack([_scatter_1d(rgb[..., c].reshape(-1), flat, ok,
                                     B * R * K, 0.0) for c in range(3)],
                        dim=-1).reshape(B, R, K, 3)
    return rgb_d, sigma_d


def compact_coarse(cfg: RendererConfig, warp_fn, field_fn,
                   rays: torch.Tensor, z_c: torch.Tensor, sel_c: torch.Tensor,
                   need_rgb: bool = True):
    """Coarse pass on the compacted samples, dense composite.
    warp_fn(xyz, viewdir) -> (cano, viewdir', valid); field_fn(cano,
    viewdir, valid, use_fine) -> (rgb, sigma), the view direction passed
    as the JAX package's ``_fused_fn`` passes it. Returns (out dict or
    None, weights (B, R, Kc), warped (cano, viewdir, valid)) — the warped
    survivors are reused by the fine pass."""
    B, R, Kc = z_c.shape
    xyz, vd = gather_samples(rays, z_c.reshape(B, -1), sel_c, Kc)
    cano, vd2, valid = warp_fn(xyz, vd)
    if vd2 is None:
        vd2 = vd
    rgb, sigma = field_fn(cano, vd2, valid, False)
    with trace.span("composite"):
        if not need_rgb:
            _, sigma_d = scatter_dense(None, sigma[..., 0], sel_c, R, Kc)
            weights, _ = composite_weights(cfg, sigma_d, rays, z_c)
            return None, weights, (cano, vd2, valid)
        rgb_d, sigma_d = scatter_dense(rgb, sigma[..., 0], sel_c, R, Kc)
        weights, rgb_c, depth_c, alpha_c = composite(cfg, rgb_d, sigma_d,
                                                     rays, z_c)
    return ({"rgbs": rgb_c, "alphas": alpha_c, "depths": depth_c}, weights,
            (cano, vd2, valid))


def compact_fine(cfg: RendererConfig, warp_fn, field_fn, rays: torch.Tensor,
                 z_c: torch.Tensor, z_f: torch.Tensor, sel_c: torch.Tensor,
                 warped_c, sel_f: torch.Tensor):
    """Fine pass: warp only the compacted fine samples, one fine-field
    evaluation over (compacted coarse + compacted fine), then the per-ray
    depth merge-sort of the channel-leading [r|g|b|sigma|z] payload
    (``sort_by_depth``: the lane permute kernel up to 128 samples a ray,
    the point-major sort above), and the composite."""
    B, R, Kc = z_c.shape
    Kf = z_f.shape[-1]
    Kall = Kc + Kf

    xyz_f, vd_f = gather_samples(rays, z_f.reshape(B, -1), sel_f, Kf)
    cano_f, vd_f2, valid_f = warp_fn(xyz_f, vd_f)
    if vd_f2 is None:
        vd_f2 = vd_f
    cano_c, vd_c, valid_c = warped_c
    rgb, sigma = field_fn(torch.cat([cano_c, cano_f], dim=1),
                          torch.cat([vd_c, vd_f2], dim=1),
                          torch.cat([valid_c, valid_f], dim=1), True)

    # dense concat layout (R, Kc + Kf), coarse slots first — the dense
    # renderer's concat order before its stable argsort; a padded entry
    # (sel == R*K) maps to R*Kall, still out of bounds
    with trace.span("composite"):
        idx_c = (sel_c // Kc) * Kall + (sel_c % Kc)
        idx_f = (sel_f // Kf) * Kall + Kc + (sel_f % Kf)
        sel_all = torch.cat([idx_c, idx_f], dim=1)
        z_all = torch.cat([z_c, z_f], dim=-1)

        flat, ok = _flat_scatter_indices(sel_all, R * Kall)
        n = B * R * Kall
        rows = [_scatter_1d(rgb[..., c].reshape(-1), flat, ok, n, 0.0)
                for c in range(3)]
        rows.append(_scatter_1d(sigma[..., 0].reshape(-1), flat, ok, n,
                                SIGMA_OUTSIDE))
        pay = torch.stack([r.reshape(B, R, Kall) for r in rows]
                          + [z_all.to(rows[0].dtype)], dim=1)  # (B,5,R,Kall)
        sp = sort_by_depth(pay, z_all)
        _, rgb_f, depth_f, alpha_f = composite_rows(cfg, sp, rays, sp[:, 4])
    return {"rgbs": rgb_f, "alphas": alpha_f, "depths": depth_f}


def scatter_warped(warped_c, sel_c: torch.Tensor, R: int, K: int):
    """Scatter compacted warp outputs (cano, viewdir, valid) (B, cap, C)
    into dense (B, R, K, C) grids with a zero fill: an unselected sample
    gets valid == 0, the state the dense warp leaves it in (invalid, its
    sigma filled downstream), so a dense fine pass over these grids is
    value-identical to the dense renderer's reuse of the coarse warp."""
    B = sel_c.shape[0]
    flat, ok = _flat_scatter_indices(sel_c, R * K)

    def scat(t: torch.Tensor) -> torch.Tensor:
        C = t.shape[-1]
        return torch.stack([_scatter_1d(t.reshape(-1, C)[:, c], flat, ok,
                                        B * R * K, 0.0)
                            for c in range(C)], dim=-1).reshape(B, R, K, C)

    cano, vd, valid = warped_c
    return scat(cano), scat(vd), None if valid is None else scat(valid)


def render_rays_compact(cfg: RendererConfig, warp_fn, field_fn,
                        rays: torch.Tensor, knn_fn, blend_fn,
                        keep_thr: float, perturb: float = 0.0, noise=None):
    """The point-major compacted render of the training step (JAX
    ``render_rays_compact``): (B, R, 8) root-frame rays -> (outputs as
    ``render_rays_split`` gives them, the largest per-row count of coarse
    survivors (an int)).

    The kNN runs dense over the coarse samples (knn_fn(xyz (B, N, 3)) ->
    (dists, idx) (B, N, k)); its nearest distance is the exact validity
    test (the blended distance is a convex combination of neighbour
    distances), so ``keep = dists[..., 0] < keep_thr``. The blend
    (blend_fn(xyz, viewdir, dists, idx) -> (cano, viewdir', valid)) and
    the coarse field run on the survivors only, every one of them
    (``select_indices`` with no cap), and are scattered into the dense
    grid before the coarse composite. The fine pass runs dense: the
    coarse warp scattered back (``scatter_warped``), the fine samples
    warped by warp_fn, both merged in depth order by the lane permute
    (``sort_by_depth`` on a [cano | viewdir | valid | z] payload), one
    fine-field pass and the fine composite. ``perturb`` > 0 reads
    ``noise`` (a ``TrainNoise``) as ``render_rays_split`` does, the same
    draws in the same places, so the outputs are the dense render's.
    Fine depths are detached, as in the dense path; sample indices carry
    no gradient."""
    train = perturb > 0
    if train and noise is None:
        raise ValueError("render_rays_compact with perturb > 0 needs noise")
    z_coarse = sample_coarse(cfg, rays, perturb,
                             noise.coarse_u if train else None)
    B, R, Kc = z_coarse.shape
    xyz, vd = _ray_points(rays, z_coarse)                 # (B, R*Kc, 3)
    dists, idx = knn_fn(xyz)
    keep = dists[..., 0] < keep_thr
    with trace.wait("wait.survivors"):
        count = int(keep.sum(dim=1).max()) if B else 0
    sel_c = select_indices(keep)
    sel_g = torch.clamp_max(sel_c, xyz.shape[1] - 1)

    def g(t: torch.Tensor) -> torch.Tensor:
        return torch.gather(t, 1, sel_g[..., None].expand(
            *sel_g.shape, t.shape[-1]))

    cano, vd2, valid = blend_fn(g(xyz), g(vd), g(dists), g(idx))
    if vd2 is None:
        vd2 = g(vd)
    rgb, sigma = field_fn(cano, vd2, valid, False)
    with trace.span("composite"):
        rgb_d, sigma_d = scatter_dense(rgb, sigma[..., 0], sel_c, R, Kc)
        weights, rgb_c, depth_c, alpha_c = composite(
            cfg, rgb_d, sigma_d, rays, z_coarse,
            noise.sigma_c if train else None)
    out = {"rgbs": rgb_c, "alphas": alpha_c, "depths": depth_c}
    if cfg.n_fine <= 0:
        return out, count

    mids = 0.5 * (z_coarse[..., :-1] + z_coarse[..., 1:])
    z_f = sample_fine(cfg, mids, weights[..., 1:-1],
                      u=noise.fine_u if train else None)
    cano_d, vd_d, valid_d = scatter_warped((cano, vd2, valid), sel_c, R, Kc)
    cano_f, vd_f, valid_f = _warp(warp_fn, rays, z_f)
    z_all = torch.cat([z_coarse, z_f], dim=-1)
    # channel-leading payload (B, 8, R, K) [cano | viewdir | valid | z]
    pay = torch.cat([torch.cat([cano_d, cano_f], dim=2),
                     torch.cat([vd_d, vd_f], dim=2),
                     torch.cat([valid_d, valid_f], dim=2),
                     z_all[..., None]], dim=-1).permute(0, 3, 1, 2)
    sp = sort_by_depth(pay, z_all).permute(0, 2, 3, 1)    # (B, R, K, 8)
    rgbs, sigmas = _eval_field(field_fn, sp[..., 0:3], sp[..., 3:6],
                               sp[..., 6:7], True)
    _, rgb_f, depth_f, alpha_f = composite(
        cfg, rgbs, sigmas, rays, sp[..., 7], noise.sigma_f if train else None)
    if cfg.share_fine:
        return {"rgbs": rgb_f, "alphas": alpha_f, "depths": depth_f}, count
    out.update({"rgbs_fine": rgb_f, "alphas_fine": alpha_f,
                "depths_fine": depth_f})
    return out, count
