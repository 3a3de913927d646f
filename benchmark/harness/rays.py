"""Pinhole cameras of the benchmark's traffic (OpenGL convention, as the
reference's dataset: x right, y up, looking down -z), turntable
rotations and projection to pixels."""

from __future__ import annotations

import math

import numpy as np
import torch


def camera_rays(W: int, H: int, focal: float, cam_dist: float,
                near: float, far: float) -> np.ndarray:
    """(H * W, 8) world rays [o | d | near | far] of a camera at
    (0, 0, cam_dist) looking at the origin, unit directions, pixel
    centres at integer coordinates as the reference's ray grid."""
    j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    d = np.stack([(i - W * 0.5) / focal, -(j - H * 0.5) / focal,
                  -np.ones_like(i)], -1)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.array([0.0, 0.0, cam_dist], np.float32), d.shape)
    nf = np.broadcast_to(np.array([near, far], np.float32), d.shape[:-1] + (2,))
    return np.concatenate([o, d, nf], -1).reshape(-1, 8).astype(np.float32)


def turntable(i: int, n_views: int) -> np.ndarray:
    """View i of n: a rotation by 2 pi i / n about the y axis (4, 4)."""
    a = 2.0 * math.pi * i / n_views
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                          [-math.sin(a), 0, math.cos(a)]], np.float32)
    return P


def project(points: torch.Tensor, W: int, H: int, focal: float,
            cam_dist: float) -> torch.Tensor:
    """(..., 3) world points -> (..., 2) pixel (column, row) of the
    camera of ``camera_rays``, rounded to the nearest pixel centre."""
    z = cam_dist - points[..., 2]
    col = points[..., 0] / z * focal + W * 0.5
    row = -points[..., 1] / z * focal + H * 0.5
    return torch.stack([col, row], -1).round()


def patch_rays(centres: torch.Tensor, patch: int, W: int, H: int,
               focal: float, cam_dist: float, near: float,
               far: float) -> torch.Tensor:
    """(B, 2) pixel centres -> (B, patch * patch, 8) rays of the patch
    around each, kept inside the image."""
    half = patch // 2
    c0 = centres[:, 0].clamp(half, W - patch + half) - half
    r0 = centres[:, 1].clamp(half, H - patch + half) - half
    g = torch.arange(patch, device=centres.device, dtype=torch.float32)
    rows = (r0[:, None, None] + g[None, :, None]).expand(-1, patch, patch)
    cols = (c0[:, None, None] + g[None, None, :]).expand(-1, patch, patch)
    d = torch.stack([(cols - W * 0.5) / focal,
                     -(rows - H * 0.5) / focal,
                     -torch.ones_like(rows)], -1).reshape(
        centres.shape[0], -1, 3)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = torch.tensor([0.0, 0.0, cam_dist], device=d.device).expand_as(d)
    nf = torch.tensor([near, far], device=d.device).expand(*d.shape[:-1], 2)
    return torch.cat([o, d, nf], -1)
