"""Host-side ray generation (numpy) — copy of the JAX package's
``ops/ray_utils.py`` ray helpers.

Camera convention:
    R_ = diag(1,-1,-1) @ R ;  t_ = (1,-1,-1) * t
    c2w = [R_^T | R_^T @ (-t_)]
    dirs = ((i-cx)/fx, -(j-cy)/fy, -1), normalized  (OpenGL-style)
    ray = [o(3), d(3), near, far]  (8 floats)
"""

from __future__ import annotations

import numpy as np


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
