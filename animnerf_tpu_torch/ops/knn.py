"""Conservative validity pre-pass of the compacted render.

Counterpart of ``animnerf_tpu/ops/knn.py::keep_within_boxes`` (the default
``prepass="boxes"``). The kNN itself is ``ops/knn_kernel.py``.
"""

from __future__ import annotations

import torch

NB = 64  # index chunks of the vertex cloud


def keep_within_boxes(points: torch.Tensor, verts: torch.Tensor,
                      thr: float) -> torch.Tensor:
    """(B, N, 3) points, (B, V, 3) verts -> (B, N) bool, True for every
    point whose nearest-vertex distance could be < thr: split the verts
    into NB index chunks (callers pass the Morton-sorted cloud, so chunks
    are spatially tight), inflate each chunk's AABB by thr per axis
    (L-inf >= L2) and keep a point iff it lies in any box. A strict
    superset of ``min_vertex_distance < thr``, which is exact end to end:
    kept-but-invalid samples get the same sigma fill in the warp."""
    B, V = verts.shape[:2]
    nb = min(NB, V)
    pad = (-V) % nb
    vv = torch.cat([verts, verts[:, -1:].expand(B, pad, 3)], dim=1) \
        if pad else verts
    vv = vv.reshape(B, nb, -1, 3)
    lo = vv.amin(dim=2) - thr  # (B, nb, 3)
    hi = vv.amax(dim=2) + thr
    keep = torch.zeros(points.shape[:2], dtype=torch.bool,
                       device=points.device)
    for b in range(nb):
        inb = ((points >= lo[:, None, b]) & (points <= hi[:, None, b])).all(-1)
        keep |= inb
    return keep
