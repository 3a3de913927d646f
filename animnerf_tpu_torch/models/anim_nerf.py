"""AnimNeRF scene model — counterpart of ``animnerf_tpu/models/anim_nerf.py``.

Every option of the reference's scene: view-dependent colour
(``use_view``, ``freqs_dir``), warped view directions (``unpose_view``),
no unposing (``use_unpose: False``), per-frame deformation and appearance
codes (``deformation_dim``, ``apperance_dim``), DeRF
(``use_deformation``), a shared fine field (``share_fine``).

``warp_points`` (the kNN unpose on the fused warp-blend, with the view
direction when ``unpose_view``) and ``field_points`` ((DeRF), the
canonical MLP, the outside-shell sigma fill) are the point-major hooks
of ``render_rays_split`` and the compacted renderer; ``warp_rows`` /
``field_rows`` the rows-native hooks of the flagship configuration
(``rows_path_ok``). Whether a field takes the fused MLP (kernel 3) or the
plain ``nn.Linear`` MLP is decided once, at construction, by the JAX
package's rule (``use_fused_mlp``: the flagship architecture, unless
``fused_mlp`` is "off"). ``query_sigma`` / ``query_normal`` (the loss's
density and normal terms) run the plain trunk with the deformation code
but never DeRF, as the JAX package does (they need grad-of-grad).
The warp hooks are ``warp`` spans, the field hooks ``field`` spans
(``utils/trace.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from animnerf_tpu_torch.models.nerf import (
    DeRFMLP,
    NeRFMLP,
    rotation_from_ortho6d,
)
from animnerf_tpu_torch.models.warp import (
    FrameContext,
    unpose,
    unpose_rows,
    unpose_with_knn,
)
from animnerf_tpu_torch.ops.knn_kernel import knn
from animnerf_tpu_torch.utils import trace

SIGMA_OUTSIDE = -1e5
# the fused MLP's encoding block holds up to 128 rows
MAX_FUSED_ENC = 128


@dataclasses.dataclass(frozen=True)
class AnimNeRFConfig:
    """The scene options (reference ctor names, anim_nerf.py:42-60)."""

    freqs_xyz: int = 10
    freqs_dir: int = 4
    use_view: bool = False
    use_unpose: bool = True
    unpose_view: bool = False
    k_neigh: int = 4
    use_deformation: bool = False
    deformation_dim: int = 0
    apperance_dim: int = 0
    use_fine: bool = True
    share_fine: bool = False
    dis_threshold: float = 0.2
    query_inside: bool = False
    weight_std: float = 0.1
    # the kNN's all-far skip at dis_threshold (ops/knn_kernel.py), exact
    # end to end; no system config key sets it, as in the JAX package
    knn_far_skip: bool = False
    compute_dtype: str = "float32"
    # recompute the plain MLP in the backward (torch.utils.checkpoint)
    remat: bool = False
    # "auto"/"on": the fused MLP for flagship-architecture fields; "off":
    # the plain MLP for every field
    fused_mlp: str = "auto"


class AnimNeRFModel(nn.Module):
    """The coarse and fine canonical fields, DeRF, and the warp/field
    queries."""

    def __init__(self, cfg: AnimNeRFConfig, generator=None):
        super().__init__()
        self.cfg = cfg

        def field():
            return NeRFMLP(cfg.freqs_xyz, cfg.compute_dtype, generator,
                           freqs_dir=cfg.freqs_dir, use_view=cfg.use_view,
                           deformation_dim=cfg.deformation_dim,
                           apperance_dim=cfg.apperance_dim,
                           fused=self.use_fused_mlp, remat=cfg.remat)

        self.nerf = field()
        self.nerf_fine = (field() if cfg.use_fine and not cfg.share_fine
                          else None)
        self.derf = (DeRFMLP(cfg.freqs_xyz, cfg.deformation_dim,
                             cfg.compute_dtype, generator)
                     if cfg.use_deformation else None)

    @property
    def use_fused_mlp(self) -> bool:
        """JAX's rule (anim_nerf.py:131-145): the fused MLP computes the
        flagship architecture only (no view, no codes, no DeRF, encoding
        within its block); "off" turns it off. The port's kernels run on
        the card and their plain versions on the CPU, so "auto" is on
        wherever the architecture allows it."""
        c = self.cfg
        if c.fused_mlp == "off":
            return False
        return (not c.use_view and c.deformation_dim == 0
                and c.apperance_dim == 0 and not c.use_deformation
                and 3 + 6 * c.freqs_xyz <= MAX_FUSED_ENC)

    @property
    def rows_path_ok(self) -> bool:
        """The rows-native pipeline covers the flagship configuration:
        the fused MLP, unposing on, no view-direction warp, no DeRF."""
        c = self.cfg
        return (self.use_fused_mlp and c.use_unpose and not c.unpose_view
                and not c.use_deformation)

    def _field(self, use_fine: bool) -> NeRFMLP:
        """The fine field when asked for and not shared, else the coarse."""
        return self.nerf_fine if use_fine and self.nerf_fine is not None \
            else self.nerf

    @staticmethod
    def _expand_code(code, n: int):
        if code is None:
            return None
        return code[:, None, :].expand(code.shape[0], n, code.shape[-1])

    def query_canonical(self, xyz: torch.Tensor, viewdir=None,
                        use_fine: bool = False, deformation_code=None,
                        apperance_code=None):
        """(B, N, 3) canonical points -> (rgb (B, N, 3), sigma (B, N, 1));
        codes (B, dim) per batch row."""
        n = xyz.shape[1]
        return self._field(use_fine)(
            xyz, viewdir, self._expand_code(deformation_code, n),
            self._expand_code(apperance_code, n))

    def apply_deformation(self, xyz: torch.Tensor, valid, deformation_code):
        """DeRF's residual rigid motion (reference anim_nerf.py:194-209):
        the identity rotation where ``valid`` is 0."""
        out = self.derf(xyz, self._expand_code(deformation_code,
                                               xyz.shape[1]))
        rot = rotation_from_ortho6d(out[..., :6])
        trans = out[..., 6:9]
        if valid is not None:
            eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
            rot = valid[..., None] * rot + (1.0 - valid[..., None]) * eye
        return torch.einsum("bnmk,bnk->bnm", rot, xyz) + trans

    def warp_points(self, ctx: Optional[FrameContext], xyz: torch.Tensor,
                    viewdir=None):
        """Observed -> canonical warp -> (xyz_cano, viewdir, valid | None);
        the identity without unposing."""
        c = self.cfg
        if not c.use_unpose:
            return xyz, viewdir, None
        with trace.span("warp"):
            return unpose(ctx, xyz, viewdir, k=c.k_neigh,
                          dis_threshold=c.dis_threshold,
                          weight_std=c.weight_std,
                          unpose_view=c.unpose_view,
                          far_skip=c.knn_far_skip)

    def warp_knn(self, ctx: FrameContext, xyz: torch.Tensor):
        """The kNN half of the warp against the observed verts in mesh
        order -> (dists, idx) (B, N, k)."""
        c = self.cfg
        with trace.span("warp"):
            d, i = knn(xyz.detach().contiguous(), ctx.verts.detach()
                       .contiguous(), c.k_neigh,
                       far_skip=c.dis_threshold if c.knn_far_skip else 0.0)
        return d.transpose(1, 2), i.transpose(1, 2)

    def warp_points_with_knn(self, ctx: FrameContext, xyz: torch.Tensor,
                             viewdir, dists: torch.Tensor, idx: torch.Tensor):
        """The blend half of the warp on points whose (dists, idx) are
        known (``warp_knn``): per point equal to ``warp_points``."""
        c = self.cfg
        with trace.span("warp"):
            return unpose_with_knn(ctx, xyz, viewdir, dists, idx,
                                   dis_threshold=c.dis_threshold,
                                   weight_std=c.weight_std,
                                   unpose_view=c.unpose_view)

    def field_points(self, xyz: torch.Tensor, viewdir=None, valid=None,
                     use_fine: bool = False, deformation_code=None,
                     apperance_code=None):
        """Canonical query: (DeRF) -> MLP -> the outside-shell sigma fill
        (reference anim_nerf.py:298-307)."""
        with trace.span("field"):
            if self.cfg.use_deformation:
                xyz = self.apply_deformation(xyz, valid, deformation_code)
            rgb, sigma = self.query_canonical(
                xyz, viewdir, use_fine, deformation_code, apperance_code)
            if valid is not None:
                sigma = torch.where(valid < 1.0, torch.full_like(
                    sigma, SIGMA_OUTSIDE), sigma)
                if self.cfg.query_inside:
                    rgb = torch.where(valid < 1.0, torch.zeros_like(rgb),
                                      rgb)
            return rgb, sigma

    def apply_points(self, ctx: Optional[FrameContext], xyz: torch.Tensor,
                     viewdir=None, use_fine: bool = False,
                     deformation_code=None, apperance_code=None):
        """The whole observed-space point query: warp, then the field."""
        xyz, viewdir, valid = self.warp_points(ctx, xyz, viewdir)
        return self.field_points(xyz, viewdir, valid, use_fine,
                                 deformation_code, apperance_code)

    def warp_rows(self, ctx: FrameContext, xyz_t: torch.Tensor,
                  tile_skip: bool = False) -> torch.Tensor:
        """(B, 8, N) rows -> (B, 8, N) rows [x'|y'|z'|bd|0..]."""
        c = self.cfg
        with trace.span("warp"):
            return unpose_rows(ctx, xyz_t, k=c.k_neigh,
                               weight_std=c.weight_std,
                               far_skip=c.dis_threshold if c.knn_far_skip
                               else 0.0, tile_skip=tile_skip)

    def field_rows(self, rows: torch.Tensor, use_fine: bool) -> torch.Tensor:
        """rows (B, 8, N) [x'|y'|z'|bd|..] -> (B, 8, N) [r|g|b|sigma|0..]
        with the outside-shell sigma fill (reference anim_nerf.py:298-307)."""
        with trace.span("field"):
            out = self._field(use_fine).forward_rows(rows)
            valid = rows[:, 3:4] < self.cfg.dis_threshold
            sigma = torch.where(valid, out[:, 3:4],
                                torch.full_like(out[:, 3:4], SIGMA_OUTSIDE))
            rgb = out[:, 0:3]
            if self.cfg.query_inside:
                rgb = torch.where(valid, rgb, torch.zeros_like(rgb))
            return torch.cat([rgb, sigma, out[:, 4:]], dim=1)

    def query_sigma(self, xyz: torch.Tensor, use_fine: bool = False,
                    deformation_code=None) -> torch.Tensor:
        """(B, N, 3) canonical points -> (B, N, 1) density (plain trunk,
        the deformation code in, no DeRF: anim_nerf.py:187-197)."""
        return self._field(use_fine).get_sigma(
            xyz, self._expand_code(deformation_code, xyz.shape[1]))

    def query_normal(self, xyz: torch.Tensor, use_fine: bool = False,
                     deformation_code=None,
                     delta: float = 0.02) -> torch.Tensor:
        """d(alpha)/d(xyz) of the canonical density (reference
        nerf.py:177-190), itself differentiable (create_graph)."""
        with torch.enable_grad():
            pts = xyz if xyz.requires_grad else xyz.detach().requires_grad_()
            sigma = self.query_sigma(pts, use_fine, deformation_code)
            alpha = torch.sum(1.0 - torch.exp(-delta * torch.relu(sigma)))
            (grad,) = torch.autograd.grad(alpha, pts, create_graph=True)
        return grad
