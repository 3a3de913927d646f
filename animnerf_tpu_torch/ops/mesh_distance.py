"""Point-to-mesh signed distances in torch float64 — counterpart of
``animnerf_tpu/ops/mesh_distance.py``.

Used by ``tools/prepare_template.py`` to classify template-space points
as inside or outside the body shell. The unsigned distance is the exact
point-to-triangle distance (the closest point by Ericson's Voronoi-region
cases, in the JAX version's precedence), minimised over every face with
the first face winning a tie (``torch.argmin``, as ``np.argmin``); the
sign is that of the offset from the closest point along the normal of
that face, +1 where the offset is 0, inside negative. That is what the
JAX code computes (its docstring names the angle-weighted pseudo-normal,
its code takes the closest face's normal), so the signs are its signs.

The JAX version is numpy on the host; 64^3 points against SMPL's 13,776
faces are ~3.6e9 point-triangle pairs, so this runs on the device of its
inputs (``device=``), in chunks of points sized so that one (P, T, 3)
float64 intermediate stays below ``max_bytes``. Every dot product is
written as ``(x0*y0 + x2*y2) + x1*y1`` (the order of ``np.einsum``
over a 3-long axis) in separate elementwise operations, so a CUDA run
rounds as a CPU run does and ties fall as in the JAX version.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

DEFAULT_MAX_BYTES = 1 << 28


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of length 3 in numpy's einsum order for such
    an axis, (x0 + x2) + x1 (its two-lane inner loop), so that region
    tests and ties round as the JAX version's ``np.einsum`` does."""
    return (u[..., 0] * v[..., 0] + u[..., 2] * v[..., 2]) \
        + u[..., 1] * v[..., 1]


def closest_point_on_triangles(p: torch.Tensor, a: torch.Tensor,
                               b: torch.Tensor, c: torch.Tensor
                               ) -> torch.Tensor:
    """Closest points of p (P, 3) on each triangle (a, b, c) (T, 3) each
    -> (P, T, 3): the vertex regions A, B, C, the edges AB, AC, BC, then
    the interior, the first region that holds taking the point."""
    ab = b - a
    ac = c - a
    ap = p[:, None, :] - a[None]
    bp = p[:, None, :] - b[None]
    cp = p[:, None, :] - c[None]
    d1, d2 = _dot(ab[None], ap), _dot(ac[None], ap)
    d3, d4 = _dot(ab[None], bp), _dot(ac[None], bp)
    d5, d6 = _dot(ab[None], cp), _dot(ac[None], cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom_vbc = (d4 - d3) + (d5 - d6)

    def safe(x: torch.Tensor) -> torch.Tensor:
        return torch.where(x == 0, torch.ones_like(x), x)

    v = (d1 / safe(d1 - d3))[..., None]
    w = (d2 / safe(d2 - d6))[..., None]
    w2 = ((d4 - d3) / safe(denom_vbc))[..., None]
    denom = safe(va + vb + vc)
    v_in = (vb / denom)[..., None]
    w_in = (vc / denom)[..., None]

    cases = [
        ((d1 <= 0) & (d2 <= 0), a[None].expand_as(ap)),
        ((d3 >= 0) & (d4 <= d3), b[None].expand_as(ap)),
        ((d6 >= 0) & (d5 <= d6), c[None].expand_as(ap)),
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0), a[None] + v * ab[None]),
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0), a[None] + w * ac[None]),
        ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
         b[None] + w2 * (c - b)[None]),
    ]
    out = a[None] + v_in * ab[None] + w_in * ac[None]   # the interior
    for mask, vals in reversed(cases):   # earlier cases take precedence
        out = torch.where(mask[..., None], vals, out)
    return out


def chunk_points(num_faces: int, max_bytes: int = DEFAULT_MAX_BYTES) -> int:
    """Points a chunk: one (P, T, 3) float64 intermediate below max_bytes."""
    return max(1, int(max_bytes) // (max(num_faces, 1) * 3 * 8))


def signed_distance(points, verts, faces, chunk: Optional[int] = None,
                    sign_convention: str = "inside_negative",
                    device=None, max_bytes: int = DEFAULT_MAX_BYTES
                    ) -> torch.Tensor:
    """Signed distance (float64, on ``device``) of points (N, 3) to the
    triangle mesh (verts (V, 3), faces (F, 3)); arrays or tensors.
    ``device`` defaults to that of ``points`` (the CPU for an array);
    ``chunk`` points at a time, by default ``chunk_points(F, max_bytes)``.
    ``sign_convention="inside_negative"`` is the template pickle's (the
    reference flips trimesh's inside-positive at prepare_template.py:89);
    any other value flips it."""
    if device is None:
        device = points.device if torch.is_tensor(points) else "cpu"
    f64 = torch.float64
    points = torch.as_tensor(np.asarray(points) if not torch.is_tensor(
        points) else points).to(device, f64)
    verts = torch.as_tensor(np.asarray(verts) if not torch.is_tensor(
        verts) else verts).to(device, f64)
    faces = torch.as_tensor(np.asarray(faces) if not torch.is_tensor(
        faces) else faces).to(device, torch.int64)
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    e1, e2 = b - a, c - a
    fnormals = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                            e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                            e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], -1)
    fnormals = fnormals / (torch.sqrt(_dot(fnormals, fnormals))[:, None]
                           + 1e-12)
    if chunk is None:
        chunk = chunk_points(faces.shape[0], max_bytes)

    out = torch.empty(points.shape[0], dtype=f64, device=device)
    for i in range(0, points.shape[0], chunk):
        p = points[i:i + chunk]
        delta_all = p[:, None] - closest_point_on_triangles(p, a, b, c)
        d2 = _dot(delta_all, delta_all)                     # (P, T)
        ti = torch.argmin(d2, dim=1)                        # first minimum
        rows = torch.arange(p.shape[0], device=device)
        delta = delta_all[rows, ti]
        s = torch.sign(_dot(delta, fnormals[ti]))
        s = torch.where(s == 0, torch.ones_like(s), s)
        out[i:i + chunk] = torch.sqrt(d2[rows, ti]) * s   # + outside
    if sign_convention == "inside_negative":
        return out
    return -out
