"""Training noise drawn from explicit ``torch.Generator``s.

Counterpart of ``animnerf_tpu/utils/rng.py``: the JAX package draws every
training random number from per-batch-element keys; here the step's noise
is drawn up front into a ``TrainNoise`` container that the loss takes as
an argument. ``torch.Generator`` and ``jax.random`` give different numbers
from the same seed, so the parity tests draw the same tensors with
``jax.random`` along the JAX package's key path and pass them in.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class TrainNoise:
    """One training step's random numbers (all float32, on one device)."""

    coarse_u: torch.Tensor   # (B, R, Kc) U[0, 1): stratified jitter
    fine_u: torch.Tensor     # (B, R, Kf) U[0, 1): importance samples
    sigma_c: torch.Tensor    # (B, R, Kc) N(0, 1): coarse sigma noise
    sigma_f: torch.Tensor    # (B, R, Kc + Kf + Kd) N(0, 1): fine sigma noise
    normal_pts: torch.Tensor   # (B, V, 3) N(0, 1): normal-loss jitter
    normal_nbr: torch.Tensor   # (B, V, 3) N(0, 1): its neighbour offsets
    # (B, R, Kd) N(0, 1): the depth-guided samples (n_fine_depth); None
    # without them
    depth_n: Optional[torch.Tensor] = None

    def to(self, device) -> "TrainNoise":
        return TrainNoise(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


def draw_noise(generator: torch.Generator, B: int, R: int, cfg, V: int,
               device: Optional[torch.device] = None) -> TrainNoise:
    """Draw one step's noise for B x R rays, the sample counts of ``cfg``
    (a ``RendererConfig``) and V template vertices, on ``device`` (the
    generator's device by default)."""
    dev = generator.device if device is None else device
    n_coarse, n_fine, n_depth = cfg.n_coarse, cfg.n_fine, cfg.n_fine_depth
    f32 = torch.float32

    def uni(*shape):
        return torch.rand(shape, generator=generator, dtype=f32, device=dev)

    def nrm(*shape):
        return torch.randn(shape, generator=generator, dtype=f32, device=dev)

    return TrainNoise(coarse_u=uni(B, R, n_coarse), fine_u=uni(B, R, n_fine),
                      sigma_c=nrm(B, R, n_coarse),
                      sigma_f=nrm(B, R, n_coarse + n_fine + n_depth),
                      normal_pts=nrm(B, V, 3), normal_nbr=nrm(B, V, 3),
                      depth_n=nrm(B, R, n_depth) if n_depth else None)
