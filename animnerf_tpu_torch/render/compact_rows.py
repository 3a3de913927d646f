"""Rows-native sample-compacted rendering for the training step —
counterpart of ``animnerf_tpu/render/compact_rows.py``.

Samples stay channel-leading (B, 8, N) from the stratified sampler through
the kNN, warp-blend and fused MLP kernels, and the coarse pass runs only on
the survivors of the conservative box pre-pass. The fine MLP runs once on
[coarse survivors | fine samples]; only the per-ray [r|g|b|sigma|z]
composite payload is depth-sorted afterwards (the lane permute kernel, 5
channels). The survivors are ordered by Morton code and the dense fine
samples are Morton-permuted too (the JAX package's ``morton`` setting, on
by default on the TPU), so both kNN sweeps run with the vertex tile skip
on spatially coherent lanes.

Exactness: dropped samples lie outside the dis_threshold shell, where the
warp's own validity test gives sigma == SIGMA_OUTSIDE, so their composite
weight is exactly 0 and their cotangent zero: expanding them with the
fills is the dense result. The JAX package pads the survivors to a static
capacity rung and re-runs a step that overflowed it; here the capacity is
the exact largest per-row survivor count, read once per step (the wait
span ``wait.survivors``), so nothing overflows. The counters
``compact.survivors`` (the coarse survivors over every row) and
``compact.rows`` (rows x the capacity: the columns the coarse warp and
field run on) give the share of that work that is samples, not padding.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from animnerf_tpu_torch.models.anim_nerf import SIGMA_OUTSIDE
from animnerf_tpu_torch.ops.perm_sort import (
    compact_channels,
    compaction_ranks,
    expand_channels,
)
from animnerf_tpu_torch.render.volume_renderer import (
    RendererConfig,
    _rows_from_z,
    check_lanes,
    composite_rows,
    sample_coarse,
    sample_fine,
    sort_by_depth,
)
from animnerf_tpu_torch.utils import trace
from animnerf_tpu_torch.utils.rng import TrainNoise

FILLS = (0.0, 0.0, 0.0, SIGMA_OUTSIDE)


def _xyz(rows: torch.Tensor):
    return rows[:, 0], rows[:, 1], rows[:, 2]


def _rows_of(xyz, B: int, n: int) -> torch.Tensor:
    return torch.cat([torch.stack(tuple(xyz), dim=1),
                      xyz[0].new_zeros(B, 5, n)], dim=1)


def render_rays_rows_compact(cfg: RendererConfig, warp_rows_fn: Callable,
                             field_rows_fn: Callable, rays: torch.Tensor,
                             keep_rows_fn: Callable,
                             noise: Optional[TrainNoise] = None):
    """Two-pass render of (B, R, 8) root-frame rays with the coarse pass
    compacted. warp_rows_fn(rows) and field_rows_fn(rows, use_fine) are
    the rows-native model hooks (the warp with the kNN tile skip);
    keep_rows_fn(rows) -> (B, N) bool is the conservative pre-pass.
    ``noise`` (training) jitters the samples and the sigmas. Under
    ``share_fine`` the coarse field and composite run without a gradient
    (their weights only steer the fine samples) and the fine outputs
    replace the coarse ones (JAX compact_rows.py:156-231). Returns (out
    dict, n_c): n_c the largest per-row coarse survivor count."""
    perturb = 1.0 if noise is not None else 0.0
    B, R = rays.shape[:2]
    z_coarse = sample_coarse(cfg, rays, perturb,
                             noise.coarse_u if noise is not None else None)
    Kc = z_coarse.shape[-1]
    rows_c = _rows_from_z(rays, z_coarse)                  # (B, 8, R*Kc)

    keep_c = keep_rows_fn(rows_c)                          # (B, R*Kc)
    o, inv, n = compaction_ranks(keep_c, xyz_rows=_xyz(rows_c))
    if trace.on():
        trace.count("compact.survivors", keep_c.sum())
    with trace.wait("wait.survivors"):
        n_c = int(n)  # sizes follow from it
    cap = max(n_c, 1)
    trace.count("compact.rows", B * cap)
    sel_rows = _rows_of(compact_channels(_xyz(rows_c), o, inv, cap), B, cap)
    wout_sel = warp_rows_fn(sel_rows)

    def expand_cols(src, o, inv, K):
        dense = expand_channels(tuple(src[:, c] for c in range(4)), FILLS,
                                o, inv)
        return [c.reshape(B, R, K) for c in dense]

    def run_coarse():
        f_sel = field_rows_fn(wout_sel, False)             # (B, 8, cap)
        with trace.span("composite"):
            frows_c = torch.stack(expand_cols(f_sel, o, inv, Kc), dim=1)
            return composite_rows(
                cfg, frows_c, rays, z_coarse,
                noise.sigma_c if noise is not None else None)

    shared = cfg.n_fine > 0 and cfg.share_fine
    with torch.set_grad_enabled(torch.is_grad_enabled() and not shared):
        weights, rgb_c, depth_c, alpha_c = run_coarse()
    out = {"rgbs": rgb_c, "alphas": alpha_c, "depths": depth_c}
    if cfg.n_fine <= 0:
        return out, n_c

    mids = 0.5 * (z_coarse[..., :-1] + z_coarse[..., 1:])
    z_fine = sample_fine(cfg, mids, weights[..., 1:-1],
                         u=noise.fine_u if noise is not None else None)
    Kf = z_fine.shape[-1]
    rows_f = _rows_from_z(rays, z_fine)                    # (B, 8, R*Kf)
    # every fine sample runs (~99% lie in the shell); the Morton
    # permutation only makes their lanes coherent for the tile skip
    o_f, inv_f, _ = compaction_ranks(
        torch.ones((B, R * Kf), dtype=torch.bool, device=rays.device),
        xyz_rows=_xyz(rows_f))
    rows_f = _rows_of(compact_channels(_xyz(rows_f), o_f, inv_f, R * Kf),
                      B, R * Kf)
    wout_f = warp_rows_fn(rows_f)

    # one fine-MLP call on [coarse survivors | fine samples]: the MLP is
    # pointwise, only the composite needs depth order
    f_m = field_rows_fn(torch.cat([wout_sel, wout_f], dim=2), True)
    with trace.span("composite"):
        f_mc, f_mf = f_m[:, :, :cap], f_m[:, :, cap:]
        cols_c = expand_cols(f_mc, o, inv, Kc)
        cols_f = expand_cols(f_mf, o_f, inv_f, Kf)
        check_lanes(Kc + Kf)
        z_all = torch.cat([z_coarse, z_fine], dim=-1)
        pay = torch.stack([torch.cat([c, f], dim=-1)
                           for c, f in zip(cols_c, cols_f)] + [z_all], dim=1)

        sp = sort_by_depth(pay, z_all)
        _, rgb_f, depth_f, alpha_f = composite_rows(
            cfg, sp, rays, sp[:, 4],
            noise.sigma_f if noise is not None else None)
    if shared:
        return {"rgbs": rgb_f, "alphas": alpha_f, "depths": depth_f}, n_c
    out.update({"rgbs_fine": rgb_f, "alphas_fine": alpha_f,
                "depths_fine": depth_f})
    return out, n_c
