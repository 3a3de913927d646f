"""Observation -> canonical warping — counterpart of ``animnerf_tpu/models/warp.py``.

All per-frame geometry is computed once into a ``FrameContext``: the
observed vertices and joints rebased into the SMPL root frame, the
per-vertex obs->canonical transforms (16-channel form), and — always, as
on the TPU — the Morton-sorted vertex cloud with the permuted
[lbs | ober2cano] table that the fused kNN + warp-blend consume.

Numerical notes kept from the reference: near/far tightened to
cam_dist -/+ 1.0; the blendshape deltas are injected into the translation
column of the inverted vertex transform before left-multiplying the
template transform; neighbour weights are exp(-dist) gated by a hard
(> 0.9) LBS-weight similarity with std 0.1. Float32 products here must be
full precision: callers pin TF32 off (``utils/device.pin_fp32_geometry``).
``prepare_frame`` and ``rays_to_root_frame`` are ``body.frame`` spans
(``utils/trace.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from animnerf_tpu_torch.ops.blend import gather_blend_plain
from animnerf_tpu_torch.ops.knn_kernel import knn
from animnerf_tpu_torch.ops.perm_sort import inverse_permutation, permute
from animnerf_tpu_torch.ops.warp_blend import (
    morton_codes,
    warp_blend,
    warp_blend_rows,
)
from animnerf_tpu_torch.smpl.body_model import BodyModel, BodyModelOutput
from animnerf_tpu_torch.smpl.body_model import forward as body_forward
from animnerf_tpu_torch.utils import trace


def affine_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 4, 4) affine transforms (adjugate /
    determinant of the 3x3 block: LBS blends are affine, not rigid)."""
    M = T[..., :3, :3]
    t = T[..., :3, 3]
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    Minv = torch.stack([torch.stack([A, B, C], -1), torch.stack([D, E, F], -1),
                        torch.stack([G, H, I], -1)], -2) \
        * (1.0 / det)[..., None, None]
    tinv = -torch.einsum("...mn,...n->...m", Minv, t)
    top = torch.cat([Minv, tinv[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def transform_points(T: torch.Tensor, p: torch.Tensor,
                     directional: bool = False) -> torch.Tensor:
    """Apply (..., 4, 4) affine transforms to (..., 3) points/directions."""
    out = torch.einsum("...mn,...n->...m", T[..., :3, :3], p)
    return out if directional else out + T[..., :3, 3]


def _t16_of(T4: torch.Tensor) -> list:
    flat = T4.reshape(*T4.shape[:-2], 16)
    return [flat[..., c] for c in range(16)]


def _compose16(a: list, b: list) -> list:
    """c = a @ b on 16-channel affine transforms (rows 3 == [0,0,0,1])."""
    c: list = [None] * 16
    for i in range(3):
        for j in range(4):
            s = (a[4 * i + 0] * b[j] + a[4 * i + 1] * b[4 + j]
                 + a[4 * i + 2] * b[8 + j])
            if j == 3:
                s = s + a[4 * i + 3]
            c[4 * i + j] = s
    c[12] = c[13] = c[14] = torch.zeros_like(c[0])
    c[15] = torch.ones_like(c[0])
    return c


def _inverse16(t: list) -> list:
    """affine_inverse on 16-channel transforms."""
    a, b, c0, tx = t[0], t[1], t[2], t[3]
    d, e, f, ty = t[4], t[5], t[6], t[7]
    g, h, i, tz = t[8], t[9], t[10], t[11]
    A = e * i - f * h
    B = c0 * h - b * i
    C = b * f - c0 * e
    D = f * g - d * i
    E = a * i - c0 * g
    F = c0 * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    s = 1.0 / (a * A + b * D + c0 * G)
    A, B, C, D, E, F, G, H, I = (A * s, B * s, C * s, D * s, E * s, F * s,
                                 G * s, H * s, I * s)
    zero = torch.zeros_like(a)
    return [A, B, C, -(A * tx + B * ty + C * tz),
            D, E, F, -(D * tx + E * ty + F * tz),
            G, H, I, -(G * tx + H * ty + I * tz),
            zero, zero, zero, torch.ones_like(a)]


@dataclass
class FrameContext:
    """One (batch of) observed frame(s), rebased into the SMPL root frame."""

    verts: torch.Tensor            # (B, V, 3) observed verts, root frame
    joints: torch.Tensor           # (B, J, 3) observed joints, root frame
    ober2cano: torch.Tensor        # (B, V, 16) obs->canonical, flat 4x4
    root_inv: torch.Tensor         # (B, 4, 4) world->root transform
    verts_template: torch.Tensor   # (B, V, 3) canonical template verts
    lbs_weights: torch.Tensor      # (V, J)
    verts_morton: Optional[torch.Tensor] = None  # (B, V, 3) Morton-sorted
    table_morton: Optional[torch.Tensor] = None  # (B, V, J+16) permuted


def _forward_obs_template(model: BodyModel, params: dict,
                          params_template: dict):
    """Observed and template params (same keys and shapes) through ONE
    batched (2B) forward; the chain is per-element independent, so the
    slices equal two separate calls."""
    B = next(iter(params.values())).shape[0]
    both = body_forward(model, **{k: torch.cat([v, params_template[k]], 0)
                                  for k, v in params.items()})
    halves = [{k: v[s] for k, v in vars(both).items()}
              for s in (slice(0, B), slice(B, None))]
    return BodyModelOutput(**halves[0]), BodyModelOutput(**halves[1])


def prepare_frame(model: BodyModel, params: dict,
                  params_template: dict) -> FrameContext:
    """Body model for observed + template params, the rebased geometry,
    the obs->canonical transforms and the Morton-sorted warp inputs."""
    with trace.span("body.frame"):
        return _prepare_frame(model, params, params_template)


def _prepare_frame(model: BodyModel, params: dict,
                   params_template: dict) -> FrameContext:
    obs, tmpl = _forward_obs_template(model, params, params_template)
    root_inv = affine_inverse(obs.joints_transform[:, 0])
    J = model.num_joints
    verts = transform_points(root_inv[:, None], obs.vertices)
    joints = transform_points(root_inv[:, None], obs.joints[:, :J])

    vt16 = _compose16(_t16_of(root_inv[:, None]),
                      _t16_of(obs.vertices_transform))
    inv16 = _inverse16(vt16)
    delta = (tmpl.shape_offsets - obs.shape_offsets) + (
        tmpl.pose_offsets - obs.pose_offsets)
    inv16[3] = inv16[3] + delta[..., 0]
    inv16[7] = inv16[7] + delta[..., 1]
    inv16[11] = inv16[11] + delta[..., 2]
    ober2cano = torch.stack(_compose16(_t16_of(tmpl.vertices_transform),
                                       inv16), dim=-1)
    ctx = FrameContext(verts=verts, joints=joints, ober2cano=ober2cano,
                       root_inv=root_inv, verts_template=tmpl.vertices,
                       lbs_weights=model.lbs_weights)
    ctx.verts_morton, ctx.table_morton = _morton_inputs(ctx)
    return ctx


def _morton_inputs(ctx: FrameContext):
    """(Morton-sorted verts, permuted [lbs | ober2cano] table). A stable
    sort, as jnp.argsort: ties would otherwise permute differently. The
    sorted cloud only feeds the kNN and the box pre-pass, so it is
    detached (stop_gradient there); the table carries the gradient back
    through the permutation's inverse gather."""
    B = ctx.verts.shape[0]
    V, J = ctx.lbs_weights.shape
    verts_c = ctx.verts.detach()
    perm = torch.argsort(morton_codes(verts_c), dim=1, stable=True)
    verts_p = torch.gather(verts_c, 1, perm[..., None].expand(B, V, 3))
    table = torch.cat([ctx.lbs_weights.expand(B, V, J), ctx.ober2cano], -1)
    return verts_p, permute(table, 1, perm, inverse_permutation(perm))


def rays_to_root_frame(ctx: FrameContext, rays: torch.Tensor) -> torch.Tensor:
    """Rebase (B, R, 8) rays into the root frame, tightening near/far to
    the +/-1m shell around the body."""
    with trace.span("body.frame"):
        Tinv = ctx.root_inv[:, None]
        o = transform_points(Tinv, rays[..., 0:3])
        d = transform_points(Tinv, rays[..., 3:6], directional=True)
        cam_dist = torch.linalg.norm(o, dim=-1, keepdim=True)
        near = torch.maximum(rays[..., 6:7], cam_dist - 1.0)
        far = torch.minimum(rays[..., 7:8], cam_dist + 1.0)
        return torch.cat([o, d, near, far], dim=-1)


def _table(ctx: FrameContext) -> torch.Tensor:
    """The [lbs | ober2cano] table (B, V, J+16) in mesh order."""
    B = ctx.verts.shape[0]
    V, J = ctx.lbs_weights.shape
    return torch.cat([ctx.lbs_weights.expand(B, V, J), ctx.ober2cano], -1)


def blend_neighbour_transforms(ctx: FrameContext, xyz: torch.Tensor,
                               k: int = 4, weight_std: float = 0.1,
                               conf_gate: float = 0.9,
                               far_skip: float = 0.0):
    """kNN against the observed verts, then the confidence-gated exp(-d)
    blend of the per-vertex obs->canonical transforms (reference
    anim_nerf.py:153-178), the plain blend -> (blended_dist (B, N, 1),
    blended_transform (B, N, 4, 4))."""
    B, N = xyz.shape[:2]
    J = ctx.lbs_weights.shape[1]
    dists, idx = knn(xyz.detach().contiguous(), ctx.verts.detach()
                     .contiguous(), k, far_skip=far_skip)
    bd, bf, _ = gather_blend_plain(_table(ctx), dists.transpose(1, 2),
                                   idx.transpose(1, 2), J, float(weight_std),
                                   float(conf_gate))
    return bd, bf.reshape(B, N, 4, 4)


def unpose(ctx: FrameContext, xyz: torch.Tensor,
           viewdir: Optional[torch.Tensor] = None, k: int = 4,
           dis_threshold: float = 0.2, weight_std: float = 0.1,
           unpose_view: bool = False, far_skip: bool = False):
    """Warp (B, N, 3) observed points into canonical space: the top-k kNN
    of the detached points against the Morton-sorted cloud, then the
    point-layout warp-blend (``ops/warp_blend.py::warp_blend``), which
    with ``unpose_view`` also warps the (B, N, 3) view directions by the
    blended 4x4, translation included (the reference's quirk, JAX
    models/warp.py:441-446). Returns (xyz_canonical (B, N, 3), viewdir
    (warped, or the input), valid (B, N, 1)) with valid in {0., 1.}
    (reference anim_nerf.py:180-192). ``far_skip``
    (``AnimNeRFConfig.knn_far_skip``): the kNN's all-far skip at
    dis_threshold, exact end to end (such points are invalid)."""
    J = ctx.lbs_weights.shape[1]
    fs = dis_threshold if far_skip else 0.0
    dists, idx = knn(xyz.detach().contiguous(), ctx.verts_morton, k,
                     far_skip=fs)
    xyz_cano, viewdir, bd = warp_blend(
        xyz, viewdir, dists, idx, ctx.table_morton, J, float(weight_std),
        0.9, bool(unpose_view), inputs_t=True)
    return xyz_cano, viewdir, (bd < dis_threshold).to(xyz.dtype)


def unpose_with_knn(ctx: FrameContext, xyz: torch.Tensor,
                    viewdir: Optional[torch.Tensor], dists: torch.Tensor,
                    idx: torch.Tensor, dis_threshold: float = 0.2,
                    weight_std: float = 0.1, unpose_view: bool = False,
                    conf_gate: float = 0.9):
    """The post-kNN half of ``unpose`` on (dists, idx) (B, N, k) found
    against the observed verts in mesh order (``AnimNeRFModel.warp_knn``):
    the warp-blend on the mesh-order table -> (xyz_cano, viewdir,
    valid), per point equal to ``unpose``."""
    J = ctx.lbs_weights.shape[1]
    xyz_cano, viewdir, bd = warp_blend(
        xyz, viewdir, dists.detach(), idx, _table(ctx), J,
        float(weight_std), float(conf_gate), bool(unpose_view))
    return xyz_cano, viewdir, (bd < dis_threshold).to(xyz.dtype)


def unpose_rows(ctx: FrameContext, xyz_t: torch.Tensor, k: int = 4,
                weight_std: float = 0.1, far_skip: float = 0.0,
                tile_skip: bool = False) -> torch.Tensor:
    """Rows-native unpose: xyz_t (B, 8, N) rows [x|y|z|..] -> (B, 8, N)
    rows [x'|y'|z'|blended_dist|0..]: the top-k kNN of the detached points
    against the Morton-sorted cloud (``ops/knn_kernel.py::knn``: packed
    keys up to 8192 vertices, with ``tile_skip`` on Morton-ordered points
    at k=4, the exact kernel above; ``far_skip`` > 0, the dis_threshold,
    turns on its all-far skip), then the differentiable warp-blend."""
    J = ctx.lbs_weights.shape[1]
    pts = xyz_t[:, 0:3].detach().transpose(1, 2).contiguous()
    dists, idx = knn(pts, ctx.verts_morton, k, tile_skip=tile_skip,
                     far_skip=far_skip)
    return warp_blend_rows(xyz_t, dists, idx, ctx.table_morton, J,
                           float(weight_std), 0.9)
