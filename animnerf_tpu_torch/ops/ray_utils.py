"""Host-side ray generation and pixel subsampling (numpy) — copy of the
JAX package's ``ops/ray_utils.py``, with OpenCV's erode / dilate from
``utils/image.py``. The random draws take the same generator calls in
the same order, so one seed gives the same pixels in both packages.

Camera convention:
    R_ = diag(1,-1,-1) @ R ;  t_ = (1,-1,-1) * t
    c2w = [R_^T | R_^T @ (-t_)]
    dirs = ((i-cx)/fx, -(j-cy)/fy, -1), normalized  (OpenGL-style)
    ray = [o(3), d(3), near, far]  (8 floats)
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from animnerf_tpu_torch.utils.image import dilate, erode


def ray_directions(H: int, W: int, focal, c=None) -> np.ndarray:
    """Per-pixel unit view directions in camera space. Returns (H, W, 3)."""
    if c is None:
        c = [W * 0.5, H * 0.5]
    j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    dirs = np.stack(
        [(i - c[0]) / focal[0], -(j - c[1]) / focal[1], -np.ones_like(i)],
        axis=-1,
    )
    return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


def gen_rays(c2w: np.ndarray, H: int, W: int, focal, near: float, far: float,
             c=None) -> np.ndarray:
    """Dense (H, W, 8) ray grid for a camera-to-world matrix (3, 4)."""
    dirs = ray_directions(H, W, focal, c)
    rays_d = dirs @ c2w[:, :3].T
    rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape)
    n = np.full_like(rays_d[..., :1], near)
    f = np.full_like(rays_d[..., :1], far)
    return np.concatenate([rays_o, rays_d, n, f], axis=-1).astype(np.float32)


def camera_to_c2w(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """World->camera (R, t) to OpenGL-style camera-to-world (3, 4)."""
    flip = np.diag([1.0, -1.0, -1.0])
    R_ = flip @ R
    t_ = np.array([1.0, -1.0, -1.0]) * np.asarray(t).reshape(3)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = R_.T
    c2w[:3, 3] = R_.T @ (-t_)
    return c2w[:3, :4]


def rotate_rays(rays: np.ndarray, P: np.ndarray) -> np.ndarray:
    """Rotate ray origins and directions by a (4,4) or (3,3) matrix
    (the novel-view turntable)."""
    R = P[:3, :3]
    t = P[:3, 3] if P.shape[0] == 4 else np.zeros(3, np.float32)
    out = rays.copy()
    out[..., 0:3] = rays[..., 0:3] @ R.T + t
    out[..., 3:6] = rays[..., 3:6] @ R.T
    return out


# --------------------------------------------------------------- sampling


def _draw(rng: np.random.Generator, ix: np.ndarray, iy: np.ndarray, n: int):
    sel = rng.integers(0, ix.shape[0], size=n)
    return ix[sel], iy[sel]


_full_grid_cache: dict = {}


def _full_grid(H: int, W: int):
    """Shared read-only (ix, iy) ravel of the full H*W grid. Mask-independent,
    so every cached frame can alias one copy instead of carrying its own
    ~4 MB of int64 coords at 512^2."""
    hit = _full_grid_cache.get((H, W))
    if hit is None:
        ix, iy = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        ix, iy = ix.ravel(), iy.ravel()
        ix.setflags(write=False)
        iy.setflags(write=False)
        hit = _full_grid_cache[(H, W)] = (ix, iy)
    return hit


def pixel_pools(
    H: int,
    W: int,
    mask: Optional[np.ndarray] = None,
    subsampletype: str = "foreground_pixel",
    fore_erode: int = 3,
) -> dict:
    """The deterministic half of sample_pixels: the candidate coordinate
    pools the random draw selects from. Depends only on (mask, type,
    erode), so the data layer caches it per frame — the erode/dilate
    passes are the expensive part of a draw at 512^2. The morphology is
    OpenCV's (``utils/image.py``), so the pools equal the JAX package's."""
    if subsampletype == "pixel":
        return {"all": _full_grid(H, W)}
    if subsampletype == "foreground_pixel":
        m = np.ascontiguousarray(mask.reshape(H, W).astype(np.float32))
        inside = erode(m, fore_erode)
        band_in = dilate(m, fore_erode)
        band_out = dilate(m, 64) - band_in

        ix, iy = np.where(inside > 0)
        if ix.size == 0:
            ix, iy = np.where(m > 0)
        if ix.size == 0:
            ix, iy = _full_grid(H, W)

        ox, oy = np.where(band_out > 0)
        if ox.size == 0:
            ox, oy = _full_grid(H, W)
        return {"fore": (ix, iy), "band": (ox, oy)}
    if subsampletype == "foreground_patch":
        m = mask.reshape(H, W)
        ix, iy = np.where(m > 0)
        if ix.size == 0:
            ix, iy = np.array([H // 2]), np.array([W // 2])
        return {"fg": (ix, iy)}
    return {}  # 'patch' and full-grid draws need no pools


def draw_from_pools(
    rng: np.random.Generator,
    pools: dict,
    H: int,
    W: int,
    subsampletype: str = "foreground_pixel",
    subsamplesize: int = 32,
    fore_rate: float = 0.9,
) -> np.ndarray:
    """The random half of sample_pixels; the rng call sequence is exactly
    sample_pixels', so cached-pool draws are bit-identical to it."""
    n_pix = subsamplesize * subsamplesize

    if subsampletype == "pixel":
        px, py = _draw(rng, *pools["all"], n_pix)
    elif subsampletype == "foreground_pixel":
        n_fore = int(n_pix * fore_rate)
        fx, fy = _draw(rng, *pools["fore"], n_fore)
        bx, by = _draw(rng, *pools["band"], n_pix - n_fore)
        px = np.concatenate([fx, bx])
        py = np.concatenate([fy, by])
    elif subsampletype == "patch":
        x0 = rng.integers(0, max(H - subsamplesize, 1))
        y0 = rng.integers(0, max(W - subsamplesize, 1))
        px, py = np.meshgrid(np.arange(x0, x0 + subsamplesize),
                             np.arange(y0, y0 + subsamplesize), indexing="ij")
        px, py = px.ravel(), py.ravel()
    elif subsampletype == "foreground_patch":
        cx, cy = _draw(rng, *pools["fg"], 1)
        half = subsamplesize // 2
        x0 = int(np.clip(cx[0] - half, 0, H - subsamplesize))
        y0 = int(np.clip(cy[0] - half, 0, W - subsamplesize))
        px, py = np.meshgrid(np.arange(x0, x0 + subsamplesize),
                             np.arange(y0, y0 + subsamplesize), indexing="ij")
        px, py = px.ravel(), py.ravel()
    else:  # full grid
        px, py = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        px, py = px.ravel(), py.ravel()

    return np.stack([px, py], axis=-1).astype(np.int64)


def sample_pixels(
    rng: np.random.Generator,
    H: int,
    W: int,
    mask: Optional[np.ndarray] = None,
    subsampletype: str = "foreground_pixel",
    subsamplesize: int = 32,
    fore_rate: float = 0.9,
    fore_erode: int = 3,
) -> np.ndarray:
    """Pixel-coordinate subsampling for training rays.

    Returns (subsamplesize^2, 2) int array of (row, col), or the full grid
    for unknown types.

    'foreground_pixel' draws fore_rate of the pixels from the eroded mask
    interior and the rest from a dilate(64)-dilate(erode) outside band.
    """
    pools = pixel_pools(H, W, mask, subsampletype, fore_erode)
    return draw_from_pools(rng, pools, H, W, subsampletype, subsamplesize,
                           fore_rate)


def ndc_rays(H: int, W: int, focal: float, near, rays_o: np.ndarray,
             rays_d: np.ndarray):
    """World rays -> NDC cube rays (unbounded forward-facing scenes).

    Not on the human-body path, where the +-1 m root-frame shell bounds
    every scene; kept for API completeness. Origins are first
    advanced onto the near plane, then the standard NeRF NDC projection is
    applied; returns (rays_o_ndc, rays_d_ndc).
    """
    o, d = np.asarray(rays_o, np.float32), np.asarray(rays_d, np.float32)
    near = np.broadcast_to(np.asarray(near, np.float32), o[..., 2].shape)

    t = -(near + o[..., 2]) / d[..., 2]
    o = o + t[..., None] * d

    ox_oz = o[..., 0] / o[..., 2]
    oy_oz = o[..., 1] / o[..., 2]
    sx, sy = -2.0 * focal / W, -2.0 * focal / H

    o0 = sx * ox_oz
    o1 = sy * oy_oz
    o2 = 1.0 + 2.0 * near / o[..., 2]
    d0 = sx * (d[..., 0] / d[..., 2] - ox_oz)
    d1 = sy * (d[..., 1] / d[..., 2] - oy_oz)
    d2 = 1.0 - o2
    return (np.stack([o0, o1, o2], axis=-1),
            np.stack([d0, d1, d2], axis=-1))
