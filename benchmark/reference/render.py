"""Anim-NeRF's two-pass volume rendering in plain float32 PyTorch.

Per ray: ``n_samples`` depths linear between near and far (stratified
when training), each point warped to the canonical pose by the k nearest
posed vertices' observed-to-canonical transforms (weights exp(-d), a
neighbour kept when its LBS weights are within exp(-L1 / (2 * 0.1^2)) >
0.9 of the nearest's, normalised), sigma set to -1e5 where the blended
distance is not below ``dis_threshold``, alpha compositing over a white
background; then ``n_importance`` depths by inverting the coarse weights'
CDF, and the fine field over all samples in depth order.

The nearest-vertex search, distances and gate carry no gradient, as in
the paper's code. A sample whose nearest vertex lies at ``dis_threshold``
or farther cannot be valid (the blended distance is a convex combination
of the neighbours'), so only the others go through the field: the same
result as evaluating every sample.
"""

from __future__ import annotations

import contextlib

import torch

from reference import field as fld

SIGMA_OUTSIDE = -1e5
WEIGHT_STD = 0.1
CONF_GATE = 0.9
KNN_CHUNK = 32768


@contextlib.contextmanager
def plain_precision(tf32: bool = False):
    """Full float32 products (TF32 off) inside, the old settings after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def steps(num: int, stop: float, device) -> torch.Tensor:
    """num float32 steps from 0 to stop, stop exact."""
    s = torch.arange(num - 1, dtype=torch.float32, device=device) / float(
        num - 1)
    stop_t = torch.tensor(stop, dtype=torch.float32, device=device)
    return torch.cat([stop_t * s, stop_t.reshape(1)])


def sample_coarse(rays: torch.Tensor, K: int, u=None) -> torch.Tensor:
    near, far = rays[..., 6:7], rays[..., 7:8]
    s = steps(K, 1.0 - 1.0 / K, rays.device)
    z = near * (1.0 - s) + far * s
    if u is not None:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], -1)
        lower = torch.cat([z[..., :1], mids], -1)
        z = lower + (upper - lower) * u
    return z


def sample_fine(z_c: torch.Tensor, weights: torch.Tensor, Kf: int,
                u=None, eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF depths over the coarse mid-bins from the interior
    coarse weights; u uniform (training) or evenly spaced in [0, 1]."""
    bins = (0.5 * (z_c[..., 1:] + z_c[..., :-1])).detach()
    w = weights[..., 1:-1].detach() + eps
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    if u is None:
        u = steps(Kf, 1.0, z_c.device).expand(*z_c.shape[:-1], Kf)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
    b0, b1 = bins.gather(-1, below), bins.gather(-1, above)
    den = c1 - c0
    den = torch.where(den < eps, torch.ones_like(den), den)
    return (b0 + (u - c0) / den * (b1 - b0)).detach()


def composite(rgb, sigma, z, far, noise=None):
    """rgb (R, K, 3), sigma/z (R, K), far (R, 1) -> weights, rgb (R, 3),
    depth (R, 1), alpha (R, 1) over a white background."""
    if noise is not None:
        sigma = sigma + noise
    delta = torch.cat([z[..., 1:] - z[..., :-1],
                       torch.full_like(z[..., :1], 1e10)], -1)
    alpha = 1.0 - torch.exp(-delta * torch.relu(sigma))
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]),
                                     1.0 - alpha + 1e-10], -1), -1)[..., :-1]
    w = alpha * trans
    acc = w.sum(-1, keepdim=True)
    rgb_out = (w[..., None] * rgb).sum(-2) + (1.0 - acc)
    depth = (w * z).sum(-1, keepdim=True) + (1.0 - acc) * far
    return w, rgb_out, depth, acc


def nearest(points: torch.Tensor, verts: torch.Tensor, k: int):
    """(N, 3), (V, 3) -> distances (N, k) ascending and indices, without
    gradient: k + 4 candidates a point by |p|^2 - 2 p.v + |v|^2, then
    the k nearest of them by the direct (p - v)^2 sums."""
    V = verts.shape[0]
    kc = min(k + 4, V)
    d_all, i_all = [], []
    with torch.no_grad():
        v2 = (verts * verts).sum(-1)
        for s in range(0, points.shape[0], KNN_CHUNK):
            p = points[s:s + KNN_CHUNK]
            d2 = torch.addmm(v2[None], p, verts.T, alpha=-2.0) \
                + (p * p).sum(-1, keepdim=True)
            cand = torch.topk(d2, kc, dim=-1, largest=False).indices
            exact = ((p[:, None, :] - verts[cand]) ** 2).sum(-1)
            dk, order = torch.topk(exact, k, dim=-1, largest=False,
                                   sorted=True)
            d_all.append(dk.sqrt())
            i_all.append(cand.gather(1, order))
    if not d_all:
        return points.new_zeros(0, k), points.new_zeros(
            0, k, dtype=torch.long)
    return torch.cat(d_all), torch.cat(i_all)


def warp(frame: dict, x: torch.Tensor, k: int, thr: float):
    """Observed points (N, 3) of one frame -> (canonical points of the
    valid ones (M, 3), their indices (M,)). Points outside the vertices'
    box grown by thr cannot be valid and skip the search."""
    verts = frame["verts"].detach()
    xd = x.detach()
    box = ((xd >= verts.amin(0) - thr) & (xd <= verts.amax(0) + thr)).all(-1)
    cand = torch.nonzero(box)[:, 0]
    d, idx = nearest(xd[cand], verts, k)
    near = d[:, 0] < thr
    cand, d, idx = cand[near], d[near], idx[near]
    lbs = frame["lbs_weights"][idx]                        # (M, k, J)
    conf = torch.exp(-(lbs - lbs[:, :1]).abs().sum(-1)
                     / (2.0 * WEIGHT_STD ** 2))
    w = torch.exp(-d) * (conf > CONF_GATE).to(d.dtype)
    w = w / w.sum(-1, keepdim=True)
    bd = (w * d).sum(-1)
    keep = bd < thr
    T = torch.einsum("mk,mkij->mij", w[keep], frame["ober2cano"][idx[keep]])
    xc = torch.einsum("mij,mj->mi", T[:, :3, :3], x[cand[keep]]) \
        + T[:, :3, 3]
    return xc, cand[keep]


def field_dense(p: dict, frame: dict, x: torch.Tensor, cfg: dict,
                quant=None):
    """rgb (N, 3) and sigma (N,) of observed points (N, 3), the outside
    fill where a point is not valid."""
    xc, sel = warp(frame, x, cfg["k_neigh"], cfg["dis_threshold"])
    rgb_v, sig_v = fld.mlp(p, xc, cfg["arch"], quant)
    N = x.shape[0]
    sigma = torch.full((N,), SIGMA_OUTSIDE, device=x.device).index_put(
        (sel,), sig_v)
    rgb = x.new_zeros(N, 3).index_put((sel,), rgb_v)
    return rgb, sigma


def render_rays(pc: dict, pf: dict, frame: dict, rays: torch.Tensor,
                cfg: dict, noise=None, quant=None) -> dict:
    """Root-frame rays (R, 8) of one frame -> rgbs (R, 3), alphas and
    depths (R, 1) of the coarse pass and the same ``_fine``. ``noise``
    (training): {coarse_u, fine_u, sigma_c, sigma_f} of these rays."""
    R = rays.shape[0]
    Kc, Kf = cfg["n_samples"], cfg["n_importance"]
    n = noise or {}
    o, d, far = rays[:, None, 0:3], rays[:, None, 3:6], rays[:, 7:8]
    z_c = sample_coarse(rays, Kc, n.get("coarse_u"))
    rgb, sig = field_dense(pc, frame, (o + z_c[..., None] * d).reshape(-1, 3),
                           cfg, quant)
    w, rgb_c, dep_c, acc_c = composite(rgb.reshape(R, Kc, 3),
                                       sig.reshape(R, Kc), z_c, far,
                                       n.get("sigma_c"))
    out = {"rgbs": rgb_c, "alphas": acc_c, "depths": dep_c}
    z_f = sample_fine(z_c, w, Kf, n.get("fine_u"))
    z = torch.cat([z_c, z_f], -1)
    order = torch.argsort(z.detach(), dim=-1, stable=True)
    z = z.gather(-1, order)
    rgb, sig = field_dense(pf, frame, (o + z[..., None] * d).reshape(-1, 3),
                           cfg, quant)
    _, rgb_f, dep_f, acc_f = composite(rgb.reshape(R, Kc + Kf, 3),
                                       sig.reshape(R, Kc + Kf), z, far,
                                       n.get("sigma_f"))
    out.update(rgbs_fine=rgb_f, alphas_fine=acc_f, depths_fine=dep_f)
    return out


def rays_near_points(rays: torch.Tensor, verts: torch.Tensor, thr: float,
                     chunk: int = 1 << 26) -> torch.Tensor:
    """rays (B, R, 8), points (B, V, 3) -> (B, R) bool: does the segment
    [near, far] of the ray pass within thr of one of its row's points.
    Products in full float32 (TF32 off). With one row, rays that miss
    the points' box grown by thr are decided by that alone."""
    B, R = rays.shape[:2]
    if B == 1:
        lo = verts[0].amin(0) - thr
        hi = verts[0].amax(0) + thr
        o, d = rays[0, :, 0:3], rays[0, :, 3:6]
        inv = 1.0 / torch.where(d == 0, torch.full_like(d, 1e-30), d)
        t0, t1 = (lo - o) * inv, (hi - o) * inv
        enter = torch.maximum(torch.minimum(t0, t1).amax(-1), rays[0, :, 6])
        leave = torch.minimum(torch.maximum(t0, t1).amin(-1), rays[0, :, 7])
        cand = torch.nonzero(enter <= leave)[:, 0]
        out = torch.zeros(1, R, dtype=torch.bool, device=rays.device)
        out[0, cand] = _near(rays[:, cand], verts, thr, chunk)[0]
        return out
    return _near(rays, verts, thr, chunk)


def _near(rays, verts, thr, chunk):
    B, R = rays.shape[:2]
    step = max(1, chunk // (B * verts.shape[1]))
    out = []
    v2 = (verts * verts).sum(-1)[:, None]                      # (B, 1, V)
    with torch.no_grad(), plain_precision():
        for s in range(0, R, step):
            r = rays[:, s:s + step]
            o, d = r[..., 0:3], r[..., 3:6]
            wd = torch.bmm(d, verts.transpose(1, 2)) \
                - (o * d).sum(-1, keepdim=True)                # (w . d)
            w2 = v2 - 2.0 * torch.bmm(o, verts.transpose(1, 2)) \
                + (o * o).sum(-1, keepdim=True)                # |w|^2
            dd = (d * d).sum(-1, keepdim=True)
            t = torch.minimum(torch.maximum(wd / dd, r[..., 6:7]),
                              r[..., 7:8])
            q2 = w2 - 2.0 * t * wd + t * t * dd
            out.append(q2.amin(-1) < thr * thr)
    if not out:
        return torch.zeros(B, 0, dtype=torch.bool, device=rays.device)
    return torch.cat(out, dim=1)
