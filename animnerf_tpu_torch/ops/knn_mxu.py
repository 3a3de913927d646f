"""Matmul-form top-4 nearest vertices (the kNN benchmark tool's variant):
a CUDA kernel plus its plain version.

Counterpart of ``tools/bench_knn.py::knn_mxu`` (its kernel
``_mxu_knn_kernel``): points (B, N, 3), vertices (B, V, 3) -> dists
(B, N, 4), idx (B, N, 4), with d2 as one (V, 8) x (8, N) product of
augmented rows. As in the JAX tool, the wrapper centres both clouds on
the vertices' mean (the matmul form cancels in proportion to |p|^2 and
|v|^2) and builds the rows in plain torch ops: points
``[x, y, z, |p|^2, 1, 0, 0, 0]``, vertices ``[-2x, -2y, -2z, 1, |v|^2, 0, 0,
0]``. The kernel (``csrc/knn_mxu.cu``) sums the 8 products left to right,
each product and sum rounded on its own; ``precision="default"`` first
rounds both operands to bf16 (to nearest even), which is what the TPU's
single-pass ``Precision.DEFAULT`` product computes, ``"highest"`` keeps
f32. The top-4 follows the exact kernel's rule
(``knn_kernel.tile_slots_topk``) and the distances are
``sqrt(max(d2, 0))``.
"""

from __future__ import annotations

import torch

from animnerf_tpu_torch.ops import _build
from animnerf_tpu_torch.ops.knn_kernel import (
    check_points_verts,
    ieee_sqrt,
    tile_slots_topk,
)

K = 4  # the tool's k (its kernel's sorting network is the k=4 one)
PRECISIONS = ("highest", "default")


def augmented_rows(points: torch.Tensor, verts: torch.Tensor):
    """(B, N, 3), (B, V, 3) -> (P (B, 8, N), A (B, V, 8)) float32, centred
    on the per-batch vertex mean (bench_knn.py:87-108)."""
    c = verts.mean(dim=1, keepdim=True)
    p = points - c
    v = verts - c
    p2 = (p * p).sum(-1)
    v2 = (v * v).sum(-1)
    one_p, zero_p = torch.ones_like(p2), torch.zeros_like(p2)
    one_v, zero_v = torch.ones_like(v2), torch.zeros_like(v2)
    P = torch.stack([p[..., 0], p[..., 1], p[..., 2], p2, one_p, zero_p,
                     zero_p, zero_p], dim=1)
    A = torch.stack([-2 * v[..., 0], -2 * v[..., 1], -2 * v[..., 2], one_v,
                     v2, zero_v, zero_v, zero_v], dim=2)
    return P.contiguous(), A.contiguous()


def _check(points, verts, k, precision):
    if k != K:
        raise ValueError(f"knn_mxu computes the top-{K} only, got k={k}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    check_points_verts(points, verts, min_verts=K, max_verts=2**31 - 1)


def knn_mxu(points: torch.Tensor, verts: torch.Tensor, k: int = K,
            precision: str = "highest"):
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    _check(points, verts, k, precision)
    if points.device.type == "cpu":
        return knn_mxu_plain(points, verts, k, precision)
    P, A = augmented_rows(points.detach(), verts.detach())
    _build.check_cuda("knn_mxu", P, A)
    B, N, _ = points.shape
    d = torch.empty((B, K, N), dtype=torch.float32, device=points.device)
    i = torch.empty((B, K, N), dtype=torch.int32, device=points.device)
    if N > 0:
        _build.kernel_library().call(
            "animnerf_knn_mxu", P.data_ptr(), A.data_ptr(), d.data_ptr(),
            i.data_ptr(), B, N, verts.shape[1], int(precision == "default"),
            _build.stream_of(points))
        _build.LAUNCHES["knn_mxu"] += 1
    return d.transpose(1, 2), i.transpose(1, 2)


def mxu_d2(P: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """(B, 8, c) point rows, (B, V, 8) vertex rows -> (B, c, V) d2, the 8
    products summed left to right, each operation rounded on its own."""
    d2 = A[:, None, :, 0] * P[:, 0, :, None]
    for col in range(1, 8):
        d2.add_(A[:, None, :, col] * P[:, col, :, None])
    return d2


def knn_mxu_plain(points: torch.Tensor, verts: torch.Tensor, k: int = K,
                  precision: str = "highest", max_elems: int = 1 << 22):
    """The same in chunks over N (a (chunk x V) matrix below
    ``max_elems``): ``mxu_d2`` then ``tile_slots_topk``."""
    _check(points, verts, k, precision)
    P, A = augmented_rows(points.detach(), verts.detach())
    if precision == "default":
        P = P.to(torch.bfloat16).float()
        A = A.to(torch.bfloat16).float()
    B, N, _ = points.shape
    chunk = max(1, max_elems // verts.shape[1])
    parts = [tile_slots_topk(mxu_d2(P[:, :, s:s + chunk], A), K)
             for s in range(0, N, chunk)]
    if not parts:
        return (points.new_empty((B, 0, K)),
                torch.empty((B, 0, K), dtype=torch.int32,
                            device=points.device))
    d2 = torch.cat([p[0] for p in parts], dim=1)
    idx = torch.cat([p[1] for p in parts], dim=1)
    return ieee_sqrt(torch.clamp_min(d2, 0.0)), idx
