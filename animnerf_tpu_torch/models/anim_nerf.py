"""AnimNeRF scene model — counterpart of ``animnerf_tpu/models/anim_nerf.py``.

``warp_points`` / ``warp_rows`` (kNN unpose, ``k_neigh`` neighbours,
weight std 0.1) and
``field_points`` / ``field_rows`` (canonical MLP with the outside-shell
sigma fill) on the fused kernel path, and ``query_sigma`` /
``query_normal`` for the loss's density and normal terms on the plain
``nn.Linear`` trunk (the JAX package keeps those in XLA too: they need
grad-of-grad). The flagship field with ``use_view=False``, no latent
codes, no DeRF, unposing on and ``unpose_view`` off.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from animnerf_tpu_torch.models.nerf import NeRFMLP
from animnerf_tpu_torch.models.warp import FrameContext, unpose, unpose_rows

SIGMA_OUTSIDE = -1e5


@dataclasses.dataclass(frozen=True)
class AnimNeRFConfig:
    """The scene options the port honours (reference ctor names);
    ``system.py`` rejects the ones it does not port yet."""

    freqs_xyz: int = 10
    use_fine: bool = True
    share_fine: bool = False
    dis_threshold: float = 0.2
    k_neigh: int = 4
    query_inside: bool = False
    # the kNN's all-far skip at dis_threshold (ops/knn_kernel.py), exact
    # end to end; no system config key sets it, as in the JAX package
    knn_far_skip: bool = False
    compute_dtype: str = "float32"


class AnimNeRFModel(nn.Module):
    """The coarse and fine canonical fields plus the warp/field queries."""

    def __init__(self, cfg: AnimNeRFConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        self.nerf = NeRFMLP(cfg.freqs_xyz, cfg.compute_dtype, generator)
        self.nerf_fine = (NeRFMLP(cfg.freqs_xyz, cfg.compute_dtype, generator)
                          if cfg.use_fine and not cfg.share_fine else None)

    def _field(self, use_fine: bool) -> NeRFMLP:
        """The fine field when asked for and not shared, else the coarse."""
        return self.nerf_fine if use_fine and self.nerf_fine is not None \
            else self.nerf

    def query_canonical(self, xyz: torch.Tensor, use_fine: bool = False):
        """(B, N, 3) canonical points -> (rgb (B, N, 3), sigma (B, N, 1))."""
        return self._field(use_fine)(xyz)

    def warp_points(self, ctx: FrameContext, xyz: torch.Tensor):
        """Observed -> canonical warp; returns (xyz_cano, valid)."""
        return unpose(ctx, xyz, k=self.cfg.k_neigh,
                      dis_threshold=self.cfg.dis_threshold,
                      far_skip=self.cfg.knn_far_skip)

    def field_points(self, xyz: torch.Tensor, valid=None,
                     use_fine: bool = False):
        """Canonical query with the outside-shell sigma fill (reference
        anim_nerf.py:298-307)."""
        rgb, sigma = self.query_canonical(xyz, use_fine)
        if valid is not None:
            sigma = torch.where(valid < 1.0,
                                torch.full_like(sigma, SIGMA_OUTSIDE), sigma)
            if self.cfg.query_inside:
                rgb = torch.where(valid < 1.0, torch.zeros_like(rgb), rgb)
        return rgb, sigma

    def warp_rows(self, ctx: FrameContext, xyz_t: torch.Tensor,
                  tile_skip: bool = False) -> torch.Tensor:
        """(B, 8, N) rows -> (B, 8, N) rows [x'|y'|z'|bd|0..]."""
        c = self.cfg
        return unpose_rows(ctx, xyz_t, k=c.k_neigh,
                           far_skip=c.dis_threshold if c.knn_far_skip
                           else 0.0, tile_skip=tile_skip)

    def field_rows(self, rows: torch.Tensor, use_fine: bool) -> torch.Tensor:
        """rows (B, 8, N) [x'|y'|z'|bd|..] -> (B, 8, N) [r|g|b|sigma|0..]
        with the outside-shell sigma fill (reference anim_nerf.py:298-307)."""
        out = self._field(use_fine).forward_rows(rows)
        valid = rows[:, 3:4] < self.cfg.dis_threshold
        sigma = torch.where(valid, out[:, 3:4],
                            torch.full_like(out[:, 3:4], SIGMA_OUTSIDE))
        rgb = out[:, 0:3]
        if self.cfg.query_inside:
            rgb = torch.where(valid, rgb, torch.zeros_like(rgb))
        return torch.cat([rgb, sigma, out[:, 4:]], dim=1)

    def query_sigma(self, xyz: torch.Tensor,
                    use_fine: bool = False) -> torch.Tensor:
        """(B, N, 3) canonical points -> (B, N, 1) density (plain MLP)."""
        return self._field(use_fine).get_sigma(xyz)

    def query_normal(self, xyz: torch.Tensor, use_fine: bool = False,
                     delta: float = 0.02) -> torch.Tensor:
        """d(alpha)/d(xyz) of the canonical density (reference
        nerf.py:177-190), itself differentiable (create_graph)."""
        with torch.enable_grad():
            pts = xyz if xyz.requires_grad else xyz.detach().requires_grad_()
            sigma = self.query_sigma(pts, use_fine)
            alpha = torch.sum(1.0 - torch.exp(-delta * torch.relu(sigma)))
            (grad,) = torch.autograd.grad(alpha, pts, create_graph=True)
        return grad
