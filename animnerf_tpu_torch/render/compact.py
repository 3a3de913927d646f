"""Sample-level compacted rendering for inference — counterpart of
``animnerf_tpu/render/compact.py``.

Most samples of a frame lie outside the ``dis_threshold`` shell around the
body, where the warp gives sigma == SIGMA_OUTSIDE and zero composite
weight; the kNN, warp-blend and MLP therefore run only on the survivors of
a conservative pre-pass, and their results are scattered back into the
dense (R, K) grid before compositing — exact end to end.

The JAX package pads the survivor list to a static capacity rung (XLA
needs static shapes) and pads with the out-of-bounds index N. Eager
PyTorch has dynamic shapes: ``select_indices`` lists every survivor
exactly (``torch.nonzero``, flat order); only a batch of several rows pads
its shorter rows with N, which the gathers clamp and the scatters drop.
"""

from __future__ import annotations

from typing import Optional

import torch

from animnerf_tpu_torch.models.anim_nerf import SIGMA_OUTSIDE
from animnerf_tpu_torch.render.volume_renderer import (
    RendererConfig,
    composite,
    composite_rows,
    composite_weights,
    sort_by_depth,
)


def select_indices(keep: torch.Tensor,
                   cap: Optional[int] = None) -> torch.Tensor:
    """(B, N) bool -> (B, cap) int64 survivor indices in flat order, padded
    with N; cap defaults to the largest row count (no survivor dropped).
    With an explicit cap the result equals the JAX package's."""
    B, n = keep.shape
    rows, cols = torch.nonzero(keep, as_tuple=True)  # row-major order
    counts = keep.sum(dim=1)
    if cap is None:
        cap = int(counts.max()) if B else 0
    pos = torch.arange(len(rows), device=keep.device) \
        - (torch.cumsum(counts, 0) - counts)[rows]
    sel = torch.full((B, cap), n, dtype=torch.int64, device=keep.device)
    fits = pos < cap
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
    if not need_rgb:
        _, sigma_d = scatter_dense(None, sigma[..., 0], sel_c, R, Kc)
        weights, _ = composite_weights(cfg, sigma_d, rays, z_c)
        return None, weights, (cano, vd2, valid)
    rgb_d, sigma_d = scatter_dense(rgb, sigma[..., 0], sel_c, R, Kc)
    weights, rgb_c, depth_c, alpha_c = composite(cfg, rgb_d, sigma_d, rays,
                                                 z_c)
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
                      + [z_all.to(rows[0].dtype)], dim=1)   # (B, 5, R, Kall)
    sp = sort_by_depth(pay, z_all)
    _, rgb_f, depth_f, alpha_f = composite_rows(cfg, sp, rays, sp[:, 4])
    return {"rgbs": rgb_f, "alphas": alpha_f, "depths": depth_f}
