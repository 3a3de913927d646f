"""Volume rendering — counterpart of
``animnerf_tpu/render/volume_renderer.py``.

Semantics kept exactly: coarse z-steps are linspace(0, 1 - 1/K, K),
linear in depth (the reference's default ``lindisp=True``, whose name is
inverted); fine samples invert the CDF of the interior coarse weights
over the coarse mid-bins; alpha = 1 - exp(-delta * relu(sigma)), exclusive cumprod
transmittance, last delta 1e10, and the white background adds
(1 - sum w) to rgb and (1 - sum w) * far to depth.

Training noise arrives as tensors (``utils/rng.py::TrainNoise``), drawn
up front: the stratified jitter ``u`` of ``sample_coarse``, the
importance-sample ``u`` of ``sample_fine`` and the N(0, 1) sigma noise of
the composites (scaled by ``noise_std``). Without them these functions are
the deterministic serving path (``perturb=0``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from animnerf_tpu_torch.ops.sort_lanes import gather_lanes


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    n_coarse: int = 64
    n_fine: int = 32
    white_bkgd: bool = True
    noise_std: float = 1.0


def linspace(start: float, stop: float, num: int,
             device=None) -> torch.Tensor:
    """float32 linspace with jnp.linspace's arithmetic (start*(1-s) +
    stop*s, s = iota/div, exact endpoint), so sample depths match bit for
    bit; torch.linspace rounds some steps differently."""
    f32 = torch.float32
    start_t = torch.tensor(start, dtype=f32, device=device)
    stop_t = torch.tensor(stop, dtype=f32, device=device)
    if num == 1:
        return start_t.reshape(1)
    div = num - 1
    step = torch.arange(div, dtype=f32, device=device) / torch.tensor(
        float(div), dtype=f32, device=device)
    out = start_t * (1 - step) + stop_t * step
    return torch.cat([out, stop_t.reshape(1)])


def sample_coarse(cfg: RendererConfig, rays: torch.Tensor,
                  perturb: float = 0.0,
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Coarse depths, stratified-jittered by ``perturb * u`` (u (B, R, Kc)
    uniform) when both are given. rays (B, R, 8) -> (B, R, Kc)."""
    near, far = rays[..., 6:7], rays[..., 7:8]
    K = cfg.n_coarse
    z_steps = linspace(0.0, 1.0 - 1.0 / K, K, rays.device)
    z = near * (1.0 - z_steps) + far * z_steps
    if perturb > 0 and u is not None:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], dim=-1)
        lower = torch.cat([z[..., :1], mids], dim=-1)
        z = lower + (upper - lower) * (perturb * u)
    return z


def sample_fine(cfg: RendererConfig, bins: torch.Tensor,
                weights: torch.Tensor, eps: float = 1e-5,
                u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Importance sampling by CDF inversion, deterministic (u = linspace)
    unless ``u`` (B, R, Kf) uniform is given. bins (B, R, Kc-1) coarse mid
    depths, weights (B, R, Kc-2) interior coarse weights -> (B, R, Kf),
    detached (the reference detaches its fine depths). The two CDF-bound
    lookups go through the lane gather kernel (``gather_lanes``), which
    takes up to 128 lanes and raises on wider rows."""
    Kf = cfg.n_fine
    bins = bins.detach()
    w = weights.detach() + eps
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    if u is None:
        u = linspace(0.0, 1.0, Kf, bins.device).expand(*bins.shape[:-1], Kf)

    # "searchsorted right" by counting cdf entries <= u
    inds = torch.sum((cdf[..., None, :] <= u[..., :, None]).to(torch.int32),
                     dim=-1)
    below = torch.clamp_min(inds - 1, 0).to(torch.int32)
    above = torch.clamp_max(inds, cfg.n_coarse - 2).to(torch.int32)
    pay = torch.stack([cdf, bins], dim=1)                 # (B, 2, R, Kc-1)
    lo = gather_lanes(pay, below)
    hi = gather_lanes(pay, above)
    cdf_lo, bin_lo = lo[:, 0], lo[:, 1]
    cdf_hi, bin_hi = hi[:, 0], hi[:, 1]
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    t = (u - cdf_lo) / denom
    return bin_lo + t * (bin_hi - bin_lo)


def composite_weights(cfg: RendererConfig, sigmas: torch.Tensor,
                      rays: torch.Tensor, z_samp: torch.Tensor,
                      noise: Optional[torch.Tensor] = None):
    """Transmittance weights of depth-sorted samples. sigmas/z (B, R, K)
    -> (weights (B, R, K), weights_sum (B, R, 1)); ``noise`` (B, R, K)
    N(0, 1) adds noise_std-scaled noise to sigma (training)."""
    if noise is not None and cfg.noise_std > 0:
        sigmas = sigmas + noise * cfg.noise_std
    deltas = z_samp[..., 1:] - z_samp[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], 1e10)], -1)
    alphas = 1.0 - torch.exp(-deltas * torch.relu(sigmas))
    shifted = torch.cat([torch.ones_like(alphas[..., :1]),
                         1.0 - alphas + 1e-10], dim=-1)
    transmittance = torch.cumprod(shifted, dim=-1)[..., :-1]
    weights = alphas * transmittance
    return weights, torch.sum(weights, dim=-1, keepdim=True)


def composite(cfg: RendererConfig, rgbs: torch.Tensor, sigmas: torch.Tensor,
              rays: torch.Tensor, z_samp: torch.Tensor,
              noise: Optional[torch.Tensor] = None):
    """rgbs (B, R, K, 3), sigmas (B, R, K) -> (weights, rgb (B, R, 3),
    depth (B, R, 1), alpha_sum (B, R, 1))."""
    weights, weights_sum = composite_weights(cfg, sigmas, rays, z_samp,
                                             noise)
    rgb = torch.sum(weights[..., None] * rgbs, dim=-2)
    depth = torch.sum(weights * z_samp, dim=-1, keepdim=True)
    if cfg.white_bkgd:
        depth = depth + (1.0 - weights_sum) * rays[..., 7:8]
        rgb = rgb + (1.0 - weights_sum)
    return weights, rgb, depth, weights_sum


def composite_rows(cfg: RendererConfig, frows: torch.Tensor,
                   rays: torch.Tensor, z_samp: torch.Tensor,
                   noise: Optional[torch.Tensor] = None):
    """composite() for channel-leading fields: frows (B, C >= 4, R, K)
    rows [r|g|b|sigma|..] -> (weights, rgb (B, R, 3), depth, alpha_sum)."""
    weights, weights_sum = composite_weights(cfg, frows[:, 3], rays, z_samp,
                                             noise)
    rgb = torch.sum(weights[:, None] * frows[:, 0:3], dim=-1).transpose(1, 2)
    depth = torch.sum(weights * z_samp, dim=-1, keepdim=True)
    if cfg.white_bkgd:
        depth = depth + (1.0 - weights_sum) * rays[..., 7:8]
        rgb = rgb + (1.0 - weights_sum)
    return weights, rgb, depth, weights_sum


def _rows_from_z(rays: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """(B, R, 8) rays x (B, R, K) depths -> (B, 8, R*K) rows [x|y|z|0..],
    the input form of the warp and MLP kernels."""
    B, R, K = z.shape
    rows = [(rays[..., c:c + 1] + z * rays[..., 3 + c:4 + c]
             ).reshape(B, 1, R * K) for c in range(3)]
    rows.append(z.new_zeros(B, 5, R * K))
    return torch.cat(rows, dim=1)
