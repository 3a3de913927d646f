"""Volume rendering — counterpart of
``animnerf_tpu/render/volume_renderer.py``.

Semantics kept exactly: coarse z-steps are linspace(0, 1 - 1/K, K),
linear in depth under the reference's default ``lindisp=True`` (whose
name is inverted; False is linear in disparity); fine samples invert the
CDF of the interior coarse weights over the coarse mid-bins; alpha =
1 - exp(-delta * relu(sigma)), exclusive cumprod transmittance, last
delta 1e10, and the white background adds
(1 - sum w) to rgb and (1 - sum w) * far to depth.

Training noise arrives as tensors (``utils/rng.py::TrainNoise``), drawn
up front: the stratified jitter ``u`` of ``sample_coarse``, the
importance-sample ``u`` of ``sample_fine`` and the N(0, 1) sigma noise of
the composites (scaled by ``noise_std``). Without them these functions are
the deterministic serving path (``perturb=0``).

``render_rays_rows`` is the dense two-pass render with samples on the
lane axis (every sample of every ray through the warp and the MLP): what
``AnimNeRFSystem.render``, the evaluation step and the renderer's dense
route run on the flagship configuration. ``render_rays_split`` is the
general point-major render (``render_rays_split`` of the JAX package):
warp and field callbacks that carry view directions and latent codes,
depth-guided fine samples, any number of samples a ray, training noise;
the merged samples are depth-sorted by ``sort_payload``, a gather whose
backward is the inverse gather (``permute_samples``).

Waits (``utils/trace.py``): ``wait.upload`` around ``linspace``'s
constants, ``wait.cumprod`` around the backward of the composite's
transmittance product, which reads on the host whether a factor is 0.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from animnerf_tpu_torch.ops.perm_sort import inverse_permutation
from animnerf_tpu_torch.ops.sort_lanes import (
    LANES,
    gather_lanes,
    permute_lanes,
)
from animnerf_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    n_coarse: int = 64
    n_fine: int = 32
    # depth-guided fine samples: N(depth, depth_std) around the coarse
    # depth, clamped to [near, far] (reference volume_rendering.py:99-111)
    n_fine_depth: int = 0
    white_bkgd: bool = True
    noise_std: float = 1.0
    depth_std: float = 0.02
    # the fine pass queries the coarse field and its outputs replace the
    # coarse ones
    share_fine: bool = False
    lindisp: bool = True  # True => linear in depth (reference quirk)


def depth_normals(shape, device) -> torch.Tensor:
    """The N(0, 1) draws of the depth-guided samples when the caller
    gives none (serving): the JAX package draws them from its default key
    there; here from a CPU ``torch.Generator`` seeded 0 (other numbers,
    the same law), so a render is the same from call to call and on
    every device."""
    gen = torch.Generator()
    gen.manual_seed(0)
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(device)


def linspace(start: float, stop: float, num: int,
             device=None) -> torch.Tensor:
    """float32 linspace with jnp.linspace's arithmetic (start*(1-s) +
    stop*s, s = iota/div, exact endpoint), so sample depths match bit for
    bit; torch.linspace rounds some steps differently. Its constants are
    copied to ``device``: a ``wait.upload`` span (``utils/trace.py``)."""
    f32 = torch.float32
    with trace.wait("wait.upload"):
        start_t = torch.tensor(start, dtype=f32, device=device)
        stop_t = torch.tensor(stop, dtype=f32, device=device)
        if num == 1:
            return start_t.reshape(1)
        div = num - 1
        div_t = torch.tensor(float(div), dtype=f32, device=device)
    step = torch.arange(div, dtype=f32, device=device) / div_t
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
    if cfg.lindisp:  # linear in depth (the module docstring)
        z = near * (1.0 - z_steps) + far * z_steps
    else:  # linear in disparity
        z = 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)
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
    lookups go through the lane gather kernel (``gather_lanes``) when the
    rows fit its 128 lanes, and through ``torch.gather`` when they are
    wider, as the JAX package picks ``gather_lanes`` or XLA's
    ``take_along_axis`` by width (volume_renderer.py:110-128)."""
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
    if cdf.shape[-1] <= LANES and Kf <= LANES:
        pay = torch.stack([cdf, bins], dim=1)             # (B, 2, R, Kc-1)
        lo = gather_lanes(pay, below)
        hi = gather_lanes(pay, above)
        cdf_lo, bin_lo = lo[:, 0], lo[:, 1]
        cdf_hi, bin_hi = hi[:, 0], hi[:, 1]
    else:
        cdf_lo, cdf_hi = (torch.gather(cdf, -1, i.long())
                          for i in (below, above))
        bin_lo, bin_hi = (torch.gather(bins, -1, i.long())
                          for i in (below, above))
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    t = (u - cdf_lo) / denom
    return bin_lo + t * (bin_hi - bin_lo)


def sample_fine_depth(cfg: RendererConfig, rays: torch.Tensor,
                      depth: torch.Tensor,
                      normals: torch.Tensor) -> torch.Tensor:
    """Gaussian samples around a depth (B, R, 1), clamped to [near, far]
    (reference volume_rendering.py:99-111): normals (B, R, n_fine_depth)
    N(0, 1) -> (B, R, n_fine_depth), detached."""
    z = depth.detach().expand(*depth.shape[:-1], cfg.n_fine_depth)
    z = z + normals * cfg.depth_std
    return torch.clamp(z, rays[..., 6:7], rays[..., 7:8]).detach()


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
    cp = torch.cumprod(shifted, dim=-1)
    if cp.grad_fn is not None:
        # the product's backward reads whether any factor is 0 on the host
        trace.wait_in_backward(cp.grad_fn, "wait.cumprod")
    transmittance = cp[..., :-1]
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


def check_lanes(K: int) -> None:
    """Raise unless K samples a ray fit the merge-sort's 128 lanes."""
    if K > LANES:
        raise NotImplementedError(
            f"{K} samples per ray: the merge-sort works on {LANES} lanes")


def sort_by_depth(pay: torch.Tensor, z_all: torch.Tensor) -> torch.Tensor:
    """The per-ray depth merge-sort: pay (B, C, R, K) channel-leading
    samples ordered by their depths z_all (B, R, K) (differentiable in
    pay). Up to 128 samples on the lane permute kernel: K is padded to
    128 lanes with +inf depths, which sort last (a stable sort), so lanes
    [:K] of the result are the real samples in depth order. Wider rows
    take the point-major sort of ``sort_payload``, as the JAX package's
    compacted renderer sorts them at every width."""
    K = z_all.shape[-1]
    if K > LANES:
        order = torch.argsort(z_all.detach(), dim=-1, stable=True)
        inv = inverse_permutation(order)
        return permute_samples(pay.to(torch.float32).permute(0, 2, 3, 1),
                               order, inv).permute(0, 3, 1, 2)
    padK = LANES - K
    z_pad = torch.nn.functional.pad(z_all.detach(), (0, padK),
                                    value=float("inf"))
    pay = torch.nn.functional.pad(pay.to(torch.float32), (0, padK))
    order = torch.argsort(z_pad, dim=-1, stable=True)
    return permute_lanes(pay.contiguous(), order.to(torch.int32),
                         inverse_permutation(order).to(torch.int32))[..., :K]


def _rows_from_z(rays: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """(B, R, 8) rays x (B, R, K) depths -> (B, 8, R*K) rows [x|y|z|0..],
    the input form of the warp and MLP kernels."""
    B, R, K = z.shape
    rows = [(rays[..., c:c + 1] + z * rays[..., 3 + c:4 + c]
             ).reshape(B, 1, R * K) for c in range(3)]
    rows.append(z.new_zeros(B, 5, R * K))
    return torch.cat(rows, dim=1)


def render_rays_rows(cfg: RendererConfig, warp_rows_fn: Callable,
                     field_rows_fn: Callable, rays: torch.Tensor,
                     perturb: float = 0.0, noise=None) -> dict:
    """The dense two-pass render of (B, R, 8) root-frame rays with samples
    on the lane axis (``animnerf_tpu/render/volume_renderer.py::
    render_rays_rows``). warp_rows_fn(rows) and field_rows_fn(rows,
    use_fine) are the rows-native model hooks: coarse rows through the
    warp and the coarse field, the composite, the fine samples, their
    warp, then the warped rows of all passes with the depth in row 4 as
    one (B, 8, R, 128) payload sorted by depth per ray (the lane permute
    kernel; +inf pad depths sort last), one fine-field pass over the
    sorted samples and the fine composite; depth-guided samples
    (``n_fine_depth``) join the fine pass. ``perturb`` > 0 (training)
    reads ``noise`` (a ``TrainNoise``) as ``render_rays_split`` does, and
    the depth-guided samples its ``depth_n`` at any perturb (else
    ``depth_normals``). Returns rgbs (B, R, 3), alphas and depths
    (B, R, 1), and the same keys with ``_fine`` (under ``share_fine`` the
    coarse pass runs without a gradient and the fine outputs replace its
    own). More than 128 samples a ray take ``render_rays_split``."""
    train = perturb > 0
    if train and noise is None:
        raise ValueError("render_rays_rows with perturb > 0 needs noise")
    B, R = rays.shape[:2]
    z_coarse = sample_coarse(cfg, rays, perturb,
                             noise.coarse_u if train else None)
    Kc = z_coarse.shape[-1]
    if cfg.n_fine > 0 or cfg.n_fine_depth > 0:
        check_lanes(Kc + cfg.n_fine + cfg.n_fine_depth)
    wout_c = warp_rows_fn(_rows_from_z(rays, z_coarse))       # (B, 8, R*Kc)
    shared = cfg.n_fine > 0 and cfg.share_fine
    with torch.set_grad_enabled(torch.is_grad_enabled() and not shared):
        f = field_rows_fn(wout_c, False).reshape(B, 8, R, Kc)
        weights, rgb_c, depth_c, alpha_c = composite_rows(
            cfg, f, rays, z_coarse, noise.sigma_c if train else None)
    out = {"rgbs": rgb_c, "alphas": alpha_c, "depths": depth_c}
    if cfg.n_fine <= 0 and cfg.n_fine_depth <= 0:
        return out

    z_parts = [z_coarse]
    pay_parts = [wout_c.reshape(B, 8, R, Kc)]
    if cfg.n_fine > 0:
        mids = 0.5 * (z_coarse[..., :-1] + z_coarse[..., 1:])
        z_parts.append(sample_fine(cfg, mids, weights[..., 1:-1],
                                   u=noise.fine_u if train else None))
    if cfg.n_fine_depth > 0:
        normals = noise.depth_n if noise is not None \
            and noise.depth_n is not None else depth_normals(
                (B, R, cfg.n_fine_depth), rays.device)
        z_parts.append(sample_fine_depth(cfg, rays, depth_c, normals))
    for z in z_parts[1:]:
        pay_parts.append(warp_rows_fn(_rows_from_z(rays, z))
                         .reshape(B, 8, R, z.shape[-1]))
    z_all = torch.cat(z_parts, dim=-1)                        # (B, R, K)
    pay = torch.cat(pay_parts, dim=3)
    # the depth rides spare row 4, so it sorts with the rest
    pay = torch.cat([pay[:, 0:4], z_all[:, None], pay[:, 5:]], dim=1)
    sp = sort_by_depth(pay, z_all)
    K = z_all.shape[-1]
    f = field_rows_fn(sp.reshape(B, 8, R * K), True)
    _, rgb_f, depth_f, alpha_f = composite_rows(
        cfg, f.reshape(B, 8, R, K), rays, sp[:, 4],
        noise.sigma_f if train else None)
    if cfg.share_fine:
        return {"rgbs": rgb_f, "alphas": alpha_f, "depths": depth_f}
    out.update({"rgbs_fine": rgb_f, "alphas_fine": alpha_f,
                "depths_fine": depth_f})
    return out


# ---------------------------------------------------------------------------
# the general point-major render (render_rays_split)
# ---------------------------------------------------------------------------


class PermuteSamples(torch.autograd.Function):
    """vals (B, R, K[, C]) gathered along the sample axis (2) by a
    permutation ``order`` (B, R, K); the backward gathers the cotangent by
    its inverse ``inv`` (a permutation's adjoint), not a scatter-add."""

    @staticmethod
    def forward(ctx, vals, order, inv):
        ctx.save_for_backward(inv)
        return _gather_samples(vals, order)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return _gather_samples(g, inv), None, None


def _gather_samples(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if vals.dim() == 4:
        idx = idx[..., None].expand(*idx.shape, vals.shape[-1])
    return torch.gather(vals, 2, idx)


def permute_samples(vals: torch.Tensor, order: torch.Tensor,
                    inv: torch.Tensor) -> torch.Tensor:
    """``animnerf_tpu/render/volume_renderer.py::permute_samples``."""
    return PermuteSamples.apply(vals, order, inv)


def sort_payload(z_all: torch.Tensor, parts: list):
    """Depth-sort a merged sample set's per-sample payloads (B, R, K, C)
    with one packed permutation gather: z_all's stable argsort, the
    payloads packed behind the depth. Returns (z_sorted (B, R, K), [sorted
    parts]) with None passed through."""
    order = torch.argsort(z_all.detach(), dim=-1, stable=True)
    inv = inverse_permutation(order)
    cols, spans = [z_all[..., None]], []
    for p in parts:
        if p is None:
            spans.append(None)
            continue
        start = sum(c.shape[-1] for c in cols)
        cols.append(p.to(z_all.dtype))
        spans.append((start, start + p.shape[-1]))
    packed = permute_samples(torch.cat(cols, dim=-1), order, inv)
    return packed[..., 0], [None if sp is None else packed[..., sp[0]:sp[1]]
                            for sp in spans]


def _ray_points(rays: torch.Tensor, z_samp: torch.Tensor):
    """(B, R, 8) rays x (B, R, K) depths -> points and view directions
    (B, R*K, 3)."""
    B, R, K = z_samp.shape
    xyz = rays[..., None, 0:3] + z_samp[..., None] * rays[..., None, 3:6]
    viewdir = rays[..., None, 3:6].expand(B, R, K, 3)
    return xyz.reshape(B, R * K, 3), viewdir.reshape(B, R * K, 3)


def _warp(warp_fn: Callable, rays: torch.Tensor, z_samp: torch.Tensor):
    """Warp the sample points of (B, R, K) depths -> per-sample
    (B, R, K, C) (xyz_cano, viewdir, valid | None)."""
    B, R, K = z_samp.shape
    xyz, viewdir = _ray_points(rays, z_samp)
    cano, vd, valid = warp_fn(xyz, viewdir)

    def shape(t):
        return None if t is None else t.reshape(B, R, K, -1)

    return shape(cano), shape(vd if vd is not None else viewdir), \
        shape(valid)


def _eval_field(field_fn: Callable, cano, viewdir, valid, use_fine: bool):
    B, R, K = cano.shape[:3]

    def flat(t):
        return None if t is None else t.reshape(B, R * K, -1)

    rgb, sigma = field_fn(flat(cano), flat(viewdir), flat(valid), use_fine)
    return rgb.reshape(B, R, K, 3), sigma.reshape(B, R, K)


def render_rays_split(cfg: RendererConfig, warp_fn: Callable,
                      field_fn: Callable, rays: torch.Tensor,
                      perturb: float = 0.0, noise=None) -> dict:
    """The general coarse(+fine) render of (B, R, 8) root-frame rays
    (``animnerf_tpu/render/volume_renderer.py::render_rays_split``).

    warp_fn(xyz, viewdir) -> (xyz_cano, viewdir', valid | None) and
    field_fn(xyz_cano, viewdir, valid, use_fine) -> (rgb, sigma) on
    (B, N, C) points. Each sample is warped once: the fine pass warps only
    its own samples (importance, ``n_fine``, and depth-guided,
    ``n_fine_depth``) and the merged set is put in depth order by
    ``sort_payload`` on the cached per-sample tensors (the warp depends on
    the point only). ``perturb`` > 0 (training) reads ``noise`` (a
    ``TrainNoise``): the stratified and importance uniforms and the
    sigma noise of both composites; the depth-guided samples always read
    ``noise.depth_n`` when given, else ``depth_normals``. Under
    ``share_fine`` the coarse pass runs without a gradient (its weights
    only steer the fine samples) and the fine outputs replace the coarse
    ones; else the fine outputs come as ``*_fine``."""
    train = perturb > 0
    if train and noise is None:
        raise ValueError("render_rays_split with perturb > 0 needs noise")
    B, R = rays.shape[:2]
    z_coarse = sample_coarse(cfg, rays, perturb,
                             noise.coarse_u if train else None)
    cano_c, vd_c, valid_c = _warp(warp_fn, rays, z_coarse)

    def run_coarse():
        rgbs, sigmas = _eval_field(field_fn, cano_c, vd_c, valid_c, False)
        return composite(cfg, rgbs, sigmas, rays, z_coarse,
                         noise.sigma_c if train else None)

    if cfg.n_fine > 0 and cfg.share_fine:
        with torch.no_grad():
            weights, rgb_c, depth_c, alpha_c = run_coarse()
    else:
        weights, rgb_c, depth_c, alpha_c = run_coarse()
    out = {"rgbs": rgb_c, "alphas": alpha_c, "depths": depth_c}
    if cfg.n_fine <= 0 and cfg.n_fine_depth <= 0:
        return out

    z_parts = [z_coarse]
    warped = [(cano_c, vd_c, valid_c)]
    if cfg.n_fine > 0:
        mids = 0.5 * (z_coarse[..., :-1] + z_coarse[..., 1:])
        z_fine = sample_fine(cfg, mids, weights[..., 1:-1],
                             u=noise.fine_u if train else None)
        z_parts.append(z_fine)
        warped.append(_warp(warp_fn, rays, z_fine))
    if cfg.n_fine_depth > 0:
        normals = noise.depth_n if noise is not None \
            and noise.depth_n is not None else depth_normals(
                (B, R, cfg.n_fine_depth), rays.device)
        z_fd = sample_fine_depth(cfg, rays, depth_c, normals)
        z_parts.append(z_fd)
        warped.append(_warp(warp_fn, rays, z_fd))
    z_all = torch.cat(z_parts, dim=-1)

    def cat(i):
        parts = [w[i] for w in warped]
        return None if parts[0] is None else torch.cat(parts, dim=2)

    z_sorted, (cano_f, vd_f, valid_f) = sort_payload(
        z_all, [cat(0), cat(1), cat(2)])
    rgbs, sigmas = _eval_field(field_fn, cano_f, vd_f, valid_f, True)
    _, rgb_f, depth_f, alpha_f = composite(
        cfg, rgbs, sigmas, rays, z_sorted, noise.sigma_f if train else None)
    if cfg.share_fine:
        return {"rgbs": rgb_f, "alphas": alpha_f, "depths": depth_f}
    out.update({"rgbs_fine": rgb_f, "alphas_fine": alpha_f,
                "depths_fine": depth_f})
    return out


def render_rays(cfg: RendererConfig, point_fn: Callable, rays: torch.Tensor,
                perturb: float = 0.0, noise=None) -> dict:
    """``render_rays_split`` with one observed-space point_fn(xyz, viewdir,
    use_fine) -> (rgb, sigma) and the identity warp."""

    def warp_fn(xyz, viewdir):
        return xyz, viewdir, None

    def field_fn(xyz, viewdir, valid, use_fine):
        return point_fn(xyz, viewdir, use_fine)

    return render_rays_split(cfg, warp_fn, field_fn, rays, perturb, noise)
