"""Novel-view rendering of a trained model — counterpart of
``animnerf_tpu/render/inference.py::Renderer``, on its compacted route
and on its dense route.

Per frame: the body geometry once (``prepare_frame``), a conservative
ray cull (``cull_rays``, frames above ``max_rays_per_call`` rays;
``_maybe_hit_fn``: rays whose segment passes no inflated vertex box
composite to exact background), then the surviving rays in slabs.

- Compacted (``compact_samples``, the default): coarse samples, the
  validity pre-pass (``prepass``: "boxes", inflated vertex-chunk boxes,
  or "exact", the nearest-vertex distance below ``dis_threshold``), the
  kNN + warp-blend and the coarse MLP on the survivors only,
  deterministic fine sampling, its pre-pass, the fine warp, one fine MLP
  over coarse and fine survivors, the per-ray depth merge-sort and the
  composite; slabs of 8 x ``max_rays_per_call`` rays.
- Dense (``compact_samples=False``, or a configuration that compaction
  does not cover: DeRF, latent codes, depth-guided samples, no
  unposing): every sample of every ray, as the JAX package's
  ``_render_fn`` routes it: ``render_rays_rows`` for a rows-renderable
  configuration, ``render_rays_split`` for every other; slabs of
  ``max_rays_per_call`` rays; the image is the fine pass's. Here most
  kNN point groups of a slab are background, which the kNN's all-far
  skip (``AnimNeRFConfig.knn_far_skip``) skips; the image is the same
  with it on or off.

The view direction reaches the warp and the field on both routes. As in
the JAX package, the renderer passes no latent codes: a model with
``deformation_dim`` or ``apperance_dim`` renders through
``make_eval_step``, and the renderer raises for it.

Under a ``parallel/mesh.py::Mesh`` of more than one rank (``mesh=``, JAX
``Renderer(mesh=)``) compaction and the ray cull are off, as in the JAX
package: each frame's rays are padded to a multiple of the mesh size,
each rank renders its contiguous shard through the dense route, and the
image is gathered on every rank.

The JAX package's capacity rungs, overflow ratchet and ray padding
(``_quantize``, ``_prime_caps``, ``_fetch_ratchet``, ``_pad_ray_ids`` and
the 32768- and 8192-ray quanta) exist only because XLA compiles static
shapes. Eager PyTorch selects the survivors exactly (``torch.nonzero``)
and renders the active rays as they are, so they are dropped here; the
outputs are the same.

Spans (``utils/trace.py``): ``view.frame`` around ``render_frame`` (one
call record a view), ``view.cull`` around the ray cull, and the waits
``wait.upload`` (the frame's inputs copied to the card), ``wait.cull``
(the cull's ``torch.nonzero``) and ``wait.to_host`` (the image's copies
to the host).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from animnerf_tpu_torch.models.warp import prepare_frame, rays_to_root_frame
from animnerf_tpu_torch.parallel.mesh import (
    Mesh,
    gather_rays,
    pad_rays_for_mesh,
    shard_rows,
)
from animnerf_tpu_torch.ops.knn import keep_within_boxes, min_vertex_distance
from animnerf_tpu_torch.render.compact import (
    compact_coarse,
    compact_fine,
    select_indices,
)
from animnerf_tpu_torch.render.volume_renderer import (
    render_rays_rows,
    render_rays_split,
    sample_coarse,
    sample_fine,
)
from animnerf_tpu_torch.system import AnimNeRFSystem
from animnerf_tpu_torch.utils import trace
from animnerf_tpu_torch.utils.device import (
    DeviceLike,
    pin_fp32_geometry,
    resolve_device,
)


def turntable_rotation(i: int, n_views: int,
                       angle_deg: float = 0.0) -> np.ndarray:
    """View-i rotation: R_y(2*pi*i/N) @ R_x(-angle)."""
    ax = -math.radians(angle_deg)
    ca, sa = math.cos(ax), math.sin(ax)
    R_x = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]], np.float32)
    ay = 2.0 * math.pi * i / n_views
    cy, sy = math.cos(ay), math.sin(ay)
    R_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = R_y @ R_x
    return P


# as in the JAX package: frames above MAX_RAYS_PER_CALL rays are
# ray-culled; the dense render takes that many rays per slab, the
# compacted render 8x that
MAX_RAYS_PER_CALL = 32768


PREPASSES = ("boxes", "exact")


class Renderer:
    """Renders frames of one system on one device (CUDA unless
    ``device="cpu"``, which runs the kernels' plain versions).

    ``prepass``: "boxes" (default) keeps a sample when it lies in one of
    the Morton cloud's 64 vertex-chunk boxes inflated by dis_threshold, a
    superset of the valid samples at a fraction of the cost; "exact" keeps
    it when its nearest-vertex distance is below dis_threshold
    (``min_vertex_distance``, the min-distance kernel), the tightest
    survivor set. Both give the same image: a kept sample that is not
    valid gets the outside-shell sigma in the warp.

    ``compact_samples=False`` takes the dense route (every sample through
    the warp and the MLP); ``cull_rays=False`` renders every ray of a
    large frame (both exact: the image is the same). ``max_rays_per_call``
    (a class attribute, as in the JAX package) sets the cull's threshold
    and the slab sizes.

    ``mesh``: the ranks that split each frame's rays (the module's
    docstring); the renderer's device is then the mesh's, and
    ``last_counts`` are this rank's."""

    max_rays_per_call: int = MAX_RAYS_PER_CALL

    def __init__(self, system: AnimNeRFSystem, device: DeviceLike = None,
                 prepass: str = "boxes", compact_samples: bool = True,
                 cull_rays: bool = True, mesh: Optional[Mesh] = None):
        if prepass not in PREPASSES:
            raise ValueError(f"prepass {prepass!r}: one of {PREPASSES}")
        self.prepass = prepass
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.compact_samples = compact_samples and self.mesh is None
        self.cull_rays = cull_rays and self.mesh is None
        if mesh is not None:
            if device is not None \
                    and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device!r} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        pin_fp32_geometry()
        self.system = system.to_device(self.device)
        if system.latent_dim > 0:
            # the JAX package's Renderer passes no codes either, and its
            # field then fails on the missing code
            raise TypeError(
                "the renderer passes no latent codes: a model with "
                "deformation_dim or apperance_dim renders through "
                "training.system.make_eval_step (frame_idx picks the code)")
        # coarse / fine samples through the kNN and the MLP in the last
        # frame: the survivors (compacted), every sample of the rendered
        # rays (dense)
        self.last_counts = (0, 0)

    # -------------------------------------------------------------- inputs

    def _params(self, d: dict) -> dict:
        return {k: self._tensor(v) for k, v in d.items()}

    def _tensor(self, a) -> torch.Tensor:
        return a.to(self.device, torch.float32) if torch.is_tensor(a) \
            else torch.tensor(np.asarray(a, np.float32), device=self.device)

    def frame_context(self, body_params: dict, body_tmpl: dict):
        """The frame geometry (``prepare_frame``) of body params and
        template params (arrays or tensors, (1, dim) each) on the device."""
        with trace.wait("wait.upload"):
            params, tmpl = self._params(body_params), self._params(body_tmpl)
        with torch.no_grad():
            return prepare_frame(self.system.body_model, params, tmpl)

    def _rays_root_rotated(self, ctx, rays: torch.Tensor, P: torch.Tensor):
        rays_root = rays_to_root_frame(ctx, rays)
        o = torch.einsum("ij,brj->bri", P[:3, :3], rays_root[..., 0:3]) \
            + P[:3, 3]
        d = torch.einsum("ij,brj->bri", P[:3, :3], rays_root[..., 3:6])
        return torch.cat([o, d, rays_root[..., 6:8]], dim=-1)

    # ----------------------------------------------------------- ray cull

    def _maybe_hit_fn(self, body_params: dict, body_tmpl: dict, rays, P):
        """(B, R) bool: could any sample of this ray lie within
        dis_threshold of the body? Also returns the per-ray root-frame far.
        rays (B, R, 8), P (4, 4) host or device arrays."""
        ctx = self.frame_context(body_params, body_tmpl)
        with torch.no_grad():
            return self._maybe_hit_ctx(ctx, self._rays_root_rotated(
                ctx, self._tensor(rays), self._tensor(P)))

    def _maybe_hit_ctx(self, ctx, rays_root: torch.Tensor):
        """Slab test of the segment [near, far] against the 32 index-chunk
        vertex AABBs inflated by thr (L-inf covers L2): exact along the
        ray, conservative as a whole."""
        o, d = rays_root[..., 0:3], rays_root[..., 3:6]
        B, V = ctx.verts.shape[:2]
        nb = 32
        pad = (-V) % nb
        vv = torch.cat([ctx.verts, ctx.verts[:, -1:].expand(B, pad, 3)], 1) \
            if pad else ctx.verts
        vv = vv.reshape(B, nb, -1, 3)
        thr = self.system.scene_cfg.dis_threshold
        lo = vv.amin(dim=2) - thr
        hi = vv.amax(dim=2) + thr
        near, far = rays_root[..., 6], rays_root[..., 7]
        d0 = d == 0
        inv = 1.0 / torch.where(d0, torch.ones_like(d), d)
        t0 = (lo[:, None] - o[:, :, None]) * inv[:, :, None]  # (B, R, nb, 3)
        t1 = (hi[:, None] - o[:, :, None]) * inv[:, :, None]
        tmin = torch.minimum(t0, t1)
        tmax = torch.maximum(t0, t1)
        inside = (o[:, :, None] >= lo[:, None]) & (o[:, :, None] <= hi[:, None])
        inf = torch.full_like(tmin, math.inf)
        tmin = torch.where(d0[:, :, None], torch.where(inside, -inf, inf), tmin)
        tmax = torch.where(d0[:, :, None], torch.where(inside, inf, -inf), tmax)
        enter = torch.maximum(tmin.amax(dim=-1), near[..., None])
        exit_ = torch.minimum(tmax.amin(dim=-1), far[..., None])
        return (enter <= exit_).any(dim=-1), far

    # ------------------------------------------------------ compacted path

    def _render_compact(self, ctx, rays_root: torch.Tensor):
        """Compacted render of (1, R, 8) root-frame rays -> (rgb (1, R, 3),
        alpha (1, R), depth (1, R), n_coarse, n_fine survivors)."""
        cfg = self.system.renderer_cfg
        scene = self.system.scene
        thr = self.system.scene_cfg.dis_threshold
        z_c = sample_coarse(cfg, rays_root)
        B, R, Kc = z_c.shape

        def keep_of(z, K):
            xyz = (rays_root[..., None, 0:3]
                   + z[..., None] * rays_root[..., None, 3:6]
                   ).reshape(B, R * K, 3)
            if self.prepass == "exact":
                return min_vertex_distance(xyz, ctx.verts) < thr
            return keep_within_boxes(xyz, ctx.verts_morton, thr)

        def warp_fn(xyz, viewdir):
            return scene.warp_points(ctx, xyz, viewdir)

        sel_c = select_indices(keep_of(z_c, Kc))
        out, weights, warped_c = compact_coarse(
            cfg, warp_fn, scene.field_points, rays_root, z_c, sel_c,
            need_rgb=(cfg.n_fine <= 0))
        n_c = sel_c.shape[1]
        if cfg.n_fine <= 0:
            return (out["rgbs"], out["alphas"][..., 0], out["depths"][..., 0],
                    n_c, 0)
        mids = 0.5 * (z_c[..., :-1] + z_c[..., 1:])
        z_f = sample_fine(cfg, mids, weights[..., 1:-1])
        sel_f = select_indices(keep_of(z_f, cfg.n_fine))
        out = compact_fine(cfg, warp_fn, scene.field_points, rays_root, z_c,
                           z_f, sel_c, warped_c, sel_f)
        return (out["rgbs"], out["alphas"][..., 0], out["depths"][..., 0],
                n_c, sel_f.shape[1])

    # ---------------------------------------------------------- dense path

    def _render_dense(self, ctx, rays_root: torch.Tensor):
        """Dense render of (1, R, 8) root-frame rays -> (rgb (1, R, 3),
        alpha (1, R), depth (1, R), coarse and fine sample counts): the
        fine pass's outputs where there is one; the rows render where the
        configuration is rows-renderable, else the split render."""
        cfg = self.system.renderer_cfg
        scene = self.system.scene
        if self.system.rows_renderable():
            out = render_rays_rows(
                cfg, lambda rows: scene.warp_rows(ctx, rows),
                scene.field_rows, rays_root)
        else:
            out = render_rays_split(
                cfg, lambda xyz, vd: scene.warp_points(ctx, xyz, vd),
                scene.field_points, rays_root)
        sfx = "_fine" if "rgbs_fine" in out else ""
        R = rays_root.shape[1]
        return (out["rgbs" + sfx], out["alphas" + sfx][..., 0],
                out["depths" + sfx][..., 0], R * cfg.n_coarse,
                R * (cfg.n_fine + cfg.n_fine_depth))

    def _compaction_applicable(self) -> bool:
        """Compaction covers the kNN-unposed field without DeRF, latent
        codes or depth-guided samples (view directions are carried; JAX
        inference.py:141-149)."""
        sc = self.system.scene_cfg
        return (self.compact_samples and sc.use_unpose
                and not sc.use_deformation and sc.deformation_dim == 0
                and sc.apperance_dim == 0
                and self.system.renderer_cfg.n_fine_depth == 0)

    def _render_slabs(self, ctx, rays_root: torch.Tensor):
        if self._compaction_applicable():
            render, slab = self._render_compact, 8 * self.max_rays_per_call
        else:
            render, slab = self._render_dense, self.max_rays_per_call
        parts, n_c, n_f = [], 0, 0
        for s in range(0, rays_root.shape[1], slab):
            *out, c, f = render(ctx, rays_root[:, s:s + slab])
            parts.append(out)
            n_c, n_f = n_c + c, n_f + f
        img, mask, depth = (torch.cat([p[i] for p in parts], dim=1)
                            for i in range(3))
        return img[0], mask[0], depth[0], n_c, n_f

    def _render_sharded(self, ctx, rays_root: torch.Tensor):
        """This rank's contiguous share of the (padded) rays through the
        dense route, the outputs gathered from every rank."""
        rays_root, n = pad_rays_for_mesh(rays_root, self.mesh)
        img, mask, depth, n_c, n_f = self._render_slabs(
            ctx, shard_rows(self.mesh, rays_root, 1))
        img, mask, depth = (gather_rays(self.mesh, t, n, 0)
                            for t in (img, mask, depth))
        return img, mask, depth, n_c, n_f

    def render_frame(self, body_params: dict, body_tmpl: dict, rays,
                     P: Optional[np.ndarray] = None,
                     img_wh: Optional[tuple] = None):
        """rays (R, 8) -> numpy (img (R, 3), mask (R,), depth (R,)), or
        (H, W, 3), (H, W), (H, W) with img_wh = (W, H)."""
        with trace.span("view.frame", root=True):
            return self._render_frame(body_params, body_tmpl, rays, P,
                                      img_wh)

    def _render_frame(self, body_params, body_tmpl, rays, P, img_wh):
        if P is None:
            P = np.eye(4, dtype=np.float32)
        cfg = self.system.renderer_cfg
        ctx = self.frame_context(body_params, body_tmpl)
        with torch.no_grad():
            with trace.wait("wait.upload"):
                rays_t = self._tensor(rays)[None]
                P_t = self._tensor(P)
            n = rays_t.shape[1]
            rays_root = self._rays_root_rotated(ctx, rays_t, P_t)
            active = None
            # the cull's proof needs the shell: unposing, and no
            # depth-guided samples (JAX inference.py:379-381)
            if self.cull_rays and n > self.max_rays_per_call \
                    and self.system.scene_cfg.use_unpose \
                    and cfg.n_fine_depth == 0:
                with trace.span("view.cull"):
                    maybe, fars = self._maybe_hit_ctx(ctx, rays_root)
                    with trace.wait("wait.cull"):
                        active = torch.nonzero(maybe[0], as_tuple=False)[:, 0]
                if len(active) == n:
                    active = None
            if self.mesh is not None:
                img, mask, depth, n_c, n_f = self._render_sharded(
                    ctx, rays_root)
            elif active is None:
                img, mask, depth, n_c, n_f = self._render_slabs(ctx, rays_root)
            else:
                bg = 1.0 if cfg.white_bkgd else 0.0
                img = torch.full((n, 3), bg, device=self.device)
                mask = torch.zeros(n, device=self.device)
                # culled rays composite to depth == far under white_bkgd
                depth = fars[0].clone() if cfg.white_bkgd \
                    else torch.zeros(n, device=self.device)
                n_c = n_f = 0
                if len(active):
                    ai, am, ad, n_c, n_f = self._render_slabs(
                        ctx, rays_root[:, active])
                    img[active], mask[active], depth[active] = ai, am, ad
            self.last_counts = (n_c, n_f)
            with trace.wait("wait.to_host"):
                img, mask, depth = (t.cpu().numpy()
                                    for t in (img, mask, depth))
        if img_wh is not None:
            W, H = img_wh
            return img.reshape(H, W, 3), mask.reshape(H, W), depth.reshape(H, W)
        return img, mask, depth

    def query_sigma_observed(self, body_params: dict, body_tmpl: dict,
                             points, use_fine: bool = True,
                             chunk: int = 262144) -> np.ndarray:
        """relu(sigma) at (1, N, 3) observed-space points -> numpy (1, N, 1)
        (mesh extraction; the queries go through the unpose warp, with
        zero view directions as the JAX package passes them). The frame
        geometry once, then chunks of ``chunk`` points through
        ``warp_points`` and ``field_points``; every chunk's output stays on
        the device and the whole grid is copied to the host once."""
        scene = self.system.scene
        ctx = self.frame_context(body_params, body_tmpl)
        with torch.no_grad():
            pts = self._tensor(points)
            outs = []
            for s in range(0, pts.shape[1], chunk):
                p = pts[:, s:s + chunk]
                xyz, vd, valid = scene.warp_points(ctx, p, torch.zeros_like(p))
                _, sigma = scene.field_points(xyz, vd, valid, use_fine)
                outs.append(torch.relu(sigma))
            return torch.cat(outs, dim=1).cpu().numpy()

    def render_stream(self, frames):
        """Render a sequence of views (turntables, motion streams).
        ``frames``: iterable of dicts with body_params, body_tmpl, rays
        (R, 8), P (4, 4, optional), img_wh (optional). Yields (img, mask,
        depth) per frame, in order. Eager launches are already
        asynchronous, so the JAX package's dispatch pipelining has no
        counterpart here."""
        for f in frames:
            yield self.render_frame(f["body_params"], f["body_tmpl"],
                                    f["rays"], f.get("P"), f.get("img_wh"))
