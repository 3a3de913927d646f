"""AnimNeRF scene model, inference subset — counterpart of
``animnerf_tpu/models/anim_nerf.py``.

``warp_points`` (kNN unpose, k=4, weight std 0.1) and ``field_points``
(canonical MLP with the outside-shell sigma fill) on the fused path, which
is the only path of the serving slice: the flagship field with
``use_view=False``, no latent codes, no DeRF, unposing on and
``unpose_view`` off.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from animnerf_tpu_torch.models.nerf import NeRFMLP
from animnerf_tpu_torch.models.warp import FrameContext, unpose

SIGMA_OUTSIDE = -1e5


@dataclasses.dataclass(frozen=True)
class AnimNeRFConfig:
    """The scene options the serving slice honours (reference ctor names);
    ``system.py`` rejects the ones it does not port yet."""

    freqs_xyz: int = 10
    use_fine: bool = True
    share_fine: bool = False
    dis_threshold: float = 0.2
    query_inside: bool = False
    compute_dtype: str = "float32"


class AnimNeRFModel(nn.Module):
    """The coarse and fine canonical fields plus the warp/field queries."""

    def __init__(self, cfg: AnimNeRFConfig):
        super().__init__()
        self.cfg = cfg
        self.nerf = NeRFMLP(cfg.freqs_xyz, cfg.compute_dtype)
        self.nerf_fine = (NeRFMLP(cfg.freqs_xyz, cfg.compute_dtype)
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
        return unpose(ctx, xyz, dis_threshold=self.cfg.dis_threshold)

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
