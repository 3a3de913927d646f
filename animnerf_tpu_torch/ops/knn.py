"""Validity pre-passes of the compacted render and training.

Counterpart of ``animnerf_tpu/ops/knn.py``: ``keep_within_boxes`` (the
default ``prepass="boxes"``), ``keep_rows_within_boxes`` (its
channel-leading form, the rows-compacted training step's) and
``min_vertex_distance`` (``prepass="exact"``: the CUDA kernel
``csrc/min_dist.cu``, the counterpart of ``knn_pallas.py::_min_dist_kernel``
through ``min_dist_pallas``, with its plain version). The kNN itself is
``ops/knn_kernel.py``. Each pre-pass is a ``compact.prepass`` span
(``utils/trace.py``).
"""

from __future__ import annotations

import torch

from animnerf_tpu_torch.ops import _build
from animnerf_tpu_torch.ops.knn_kernel import (
    check_points_verts,
    exact_d2,
    ieee_sqrt,
)
from animnerf_tpu_torch.utils import trace

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
    with trace.span("compact.prepass"):
        lo, hi = _chunk_boxes(verts, thr)
        keep = torch.zeros(points.shape[:2], dtype=torch.bool,
                           device=points.device)
        for b in range(lo.shape[1]):
            keep |= ((points >= lo[:, None, b])
                     & (points <= hi[:, None, b])).all(-1)
        return keep


def keep_rows_within_boxes(xyz_t: torch.Tensor, verts: torch.Tensor,
                           thr: float) -> torch.Tensor:
    """keep_within_boxes for channel-leading rows: xyz_t (B, C >= 3, N)
    [x|y|z|..] -> (B, N) bool; the same boxes and result, on detached
    inputs."""
    with trace.span("compact.prepass"):
        xyz_t = xyz_t.detach()
        lo, hi = _chunk_boxes(verts.detach(), thr)
        x, y, z = xyz_t[:, 0], xyz_t[:, 1], xyz_t[:, 2]  # (B, N) each
        keep = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        for b in range(lo.shape[1]):
            keep |= ((x >= lo[:, b, 0:1]) & (x <= hi[:, b, 0:1])
                     & (y >= lo[:, b, 1:2]) & (y <= hi[:, b, 1:2])
                     & (z >= lo[:, b, 2:3]) & (z <= hi[:, b, 2:3]))
        return keep


def min_vertex_distance(points: torch.Tensor,
                        verts: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) points, (B, V, 3) verts -> (B, N) exact nearest-vertex
    distance, on detached inputs: kernel on CUDA tensors, plain version on
    CPU tensors."""
    with trace.span("compact.prepass"):
        return _min_vertex_distance(points, verts)


def _min_vertex_distance(points: torch.Tensor,
                         verts: torch.Tensor) -> torch.Tensor:
    check_points_verts(points, verts, min_verts=1, max_verts=2**31 - 1)
    if points.device.type == "cpu":
        return min_vertex_distance_plain(points, verts)
    points = points.detach().contiguous()
    verts = verts.detach().contiguous()
    _build.check_cuda("min_vertex_distance", points, verts)
    B, N, _ = points.shape
    out = torch.empty((B, N), dtype=torch.float32, device=points.device)
    if N == 0:
        return out
    _build.kernel_library().call(
        "animnerf_min_dist", points.data_ptr(), verts.data_ptr(),
        out.data_ptr(), B, N, verts.shape[1], _build.stream_of(points))
    _build.LAUNCHES["min_dist"] += 1
    return out


def min_vertex_distance_plain(points: torch.Tensor, verts: torch.Tensor,
                              max_elems: int = 1 << 24) -> torch.Tensor:
    """sqrt of the minimum over V of the rounded (v - p)^2 sums
    (``knn_kernel.exact_d2``), in chunks over N so the (chunk x V) matrix
    stays below ``max_elems``."""
    check_points_verts(points, verts, min_verts=1, max_verts=2**31 - 1)
    points, verts = points.detach(), verts.detach()
    chunk = max(1, max_elems // verts.shape[1])
    best = [exact_d2(points[:, s:s + chunk], verts).amin(dim=-1)
            for s in range(0, points.shape[1], chunk)]
    if not best:
        return points.new_empty(points.shape[:2])
    return ieee_sqrt(torch.cat(best, dim=1))
