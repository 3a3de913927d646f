"""Conservative validity pre-pass of the compacted render and training.

Counterpart of ``animnerf_tpu/ops/knn.py::keep_within_boxes`` (the default
``prepass="boxes"``) and ``keep_rows_within_boxes`` (its channel-leading
form, the rows-compacted training step's). The kNN itself is
``ops/knn_kernel.py``.
"""

from __future__ import annotations

import torch

NB = 64  # index chunks of the vertex cloud


def _chunk_boxes(verts: torch.Tensor, thr: float):
    """The NB index chunks' AABBs of (B, V, 3) verts, inflated by thr:
    (lo, hi), each (B, nb, 3); the last chunk is padded with the last
    vertex."""
    B, V = verts.shape[:2]
    nb = min(NB, V)
    pad = (-V) % nb
    vv = torch.cat([verts, verts[:, -1:].expand(B, pad, 3)], dim=1) \
        if pad else verts
    vv = vv.reshape(B, nb, -1, 3)
    return vv.amin(dim=2) - thr, vv.amax(dim=2) + thr


def keep_within_boxes(points: torch.Tensor, verts: torch.Tensor,
                      thr: float) -> torch.Tensor:
    """(B, N, 3) points, (B, V, 3) verts -> (B, N) bool, True for every
    point whose nearest-vertex distance could be < thr: split the verts
    into NB index chunks (callers pass the Morton-sorted cloud, so chunks
    are spatially tight), inflate each chunk's AABB by thr per axis
    (L-inf >= L2) and keep a point iff it lies in any box. A strict
    superset of ``min_vertex_distance < thr``, which is exact end to end:
    kept-but-invalid samples get the same sigma fill in the warp."""
    lo, hi = _chunk_boxes(verts, thr)
    keep = torch.zeros(points.shape[:2], dtype=torch.bool,
                       device=points.device)
    for b in range(lo.shape[1]):
        inb = ((points >= lo[:, None, b]) & (points <= hi[:, None, b])).all(-1)
        keep |= inb
    return keep


def keep_rows_within_boxes(xyz_t: torch.Tensor, verts: torch.Tensor,
                           thr: float) -> torch.Tensor:
    """keep_within_boxes for channel-leading rows: xyz_t (B, C >= 3, N)
    [x|y|z|..] -> (B, N) bool; the same boxes and result, on detached
    inputs."""
    xyz_t = xyz_t.detach()
    lo, hi = _chunk_boxes(verts.detach(), thr)
    x, y, z = xyz_t[:, 0], xyz_t[:, 1], xyz_t[:, 2]  # (B, N) each
    keep = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for b in range(lo.shape[1]):
        keep |= ((x >= lo[:, b, 0:1]) & (x <= hi[:, b, 0:1])
                 & (y >= lo[:, b, 1:2]) & (y <= hi[:, b, 1:2])
                 & (z >= lo[:, b, 2:3]) & (z <= hi[:, b, 2:3]))
    return keep
