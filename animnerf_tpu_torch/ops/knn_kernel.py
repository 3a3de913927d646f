"""Exact top-4 kNN under packed keys: CUDA kernel plus plain version.

Counterpart of ``animnerf_tpu/ops/knn_pallas.py::knn_pallas`` on its
default path (``packed=True``, k=4, the tournament kernel,
``transposed_out=True``, optional ``tile_skip``): points (B, N, 3) and the
Morton-sorted vertices (B, V, 3) -> dists (B, 4, N) ascending and idx
(B, 4, N) int32.

Each candidate's key is ``(bits(max(d2, 0)) & ~0x1FFF) | vertex_index``
with d2 in the dot form ``pp + (m2z*pz + (m2y*py + (m2x*px + vq)))``; the
4 smallest keys win (ties go to the smaller index) and the distances are
``sqrt`` of the quantized d2 (13 low mantissa bits dropped, <= 2^-10
relative on d2). Both versions compute every key bit for bit as the TPU
kernel does; the vertex index field limits V to 8192.
"""

from __future__ import annotations

import torch

from animnerf_tpu_torch.ops import _build

K = 4
KEY_MASK = ~0x1FFF
MAX_VERTS = 8192
TILE_V = 1024  # the kernel's vertex tile (csrc/knn.cu)


def _check(points: torch.Tensor, verts: torch.Tensor) -> None:
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be (B, N, 3), got {tuple(points.shape)}")
    if verts.dim() != 3 or verts.shape[-1] != 3 \
            or verts.shape[0] != points.shape[0]:
        raise ValueError(f"verts must be (B, V, 3), got {tuple(verts.shape)}")
    if points.dtype != torch.float32 or verts.dtype != torch.float32:
        raise ValueError("kNN takes float32 points and vertices")
    if not K <= verts.shape[1] <= MAX_VERTS:
        raise ValueError(f"packed kNN needs {K} <= V <= {MAX_VERTS}, "
                         f"got V={verts.shape[1]}")


def tile_boxes(verts: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) -> (B, ceil(V / TILE_V), 8) per-tile AABBs [lo xyz, hi xyz,
    0, 0] of the kernel's vertex tiles (the last tile holds only real
    vertices)."""
    B, V, _ = verts.shape
    nt = -(-V // TILE_V)
    pad = nt * TILE_V - V
    last = verts[:, -1:].expand(B, pad, 3)  # repeats a real vertex
    vt = torch.cat([verts, last], dim=1).reshape(B, nt, TILE_V, 3)
    return torch.cat([vt.amin(dim=2), vt.amax(dim=2),
                      verts.new_zeros(B, nt, 2)], dim=-1).contiguous()


def knn_top4(points: torch.Tensor, verts: torch.Tensor,
             tile_skip: bool = False, stats: torch.Tensor = None):
    """Kernel on CUDA tensors, plain version on CPU tensors (which ignores
    ``tile_skip``: the output is the same either way). ``tile_skip`` lets a
    warp skip vertex tiles that cannot hold any of its points' top-4 (exact;
    pays when the points are Morton-ordered). ``stats``: an optional int64
    CUDA tensor of 2 the kernel adds its warp-tile [swept, skipped] counts
    to."""
    _check(points, verts)
    if points.device.type == "cpu":
        return knn_top4_plain(points, verts)
    points = points.detach().contiguous()
    verts = verts.detach().contiguous()
    _build.check_cuda("knn_top4", points, verts)
    B, N, _ = points.shape
    V = verts.shape[1]
    d = torch.empty((B, K, N), dtype=torch.float32, device=points.device)
    i = torch.empty((B, K, N), dtype=torch.int32, device=points.device)
    if N == 0:
        return d, i
    vbox = tile_boxes(verts) if tile_skip else None
    if stats is not None and (stats.dtype != torch.int64
                              or stats.numel() != 2
                              or stats.device != points.device):
        raise ValueError("stats must be an int64 tensor of 2 on the device")
    _build.kernel_library().call(
        "animnerf_knn_top4", points.data_ptr(), verts.data_ptr(),
        vbox.data_ptr() if tile_skip else None, int(bool(tile_skip)),
        stats.data_ptr() if stats is not None else None, d.data_ptr(),
        i.data_ptr(), B, N, V, _build.stream_of(points))
    _build.LAUNCHES["knn"] += 1
    if tile_skip:
        _build.LAUNCHES["knn_tile_skip"] += 1
    return d, i


def knn_top4_plain(points: torch.Tensor, verts: torch.Tensor,
                   max_elems: int = 1 << 24):
    """The same packed keys in chunks over N, so the (chunk x V) key matrix
    stays below ``max_elems``; then an int top-k (smallest 4, sorted)."""
    _check(points, verts)
    B, N, _ = points.shape
    V = verts.shape[1]
    if N == 0:
        return (points.new_empty((B, K, 0)),
                torch.empty((B, K, 0), dtype=torch.int32, device=points.device))
    vx, vy, vz = (verts[..., c][:, None, :] for c in range(3))  # (B, 1, V)
    m2x, m2y, m2z = -(vx + vx), -(vy + vy), -(vz + vz)
    vq = vx * vx + vy * vy + vz * vz
    col = torch.arange(V, dtype=torch.int32, device=points.device)
    chunk = max(1, max_elems // V)
    keys = []
    for s in range(0, N, chunk):
        p = points[:, s:s + chunk]
        px, py, pz = p[..., 0:1], p[..., 1:2], p[..., 2:3]   # (B, c, 1)
        pp = px * px + py * py + pz * pz
        d2 = torch.clamp_min(pp + (m2z * pz + (m2y * py + (m2x * px + vq))),
                             0.0)
        key = (d2.view(torch.int32) & KEY_MASK) | col
        keys.append(torch.topk(key, K, dim=-1, largest=False,
                               sorted=True).values)
    top = torch.cat(keys, dim=1).transpose(1, 2).contiguous()  # (B, 4, N)
    # sqrt through float64: correctly rounded, like the kernel's sqrtf and
    # the TPU's (torch's vectorized float32 CPU sqrt is not)
    d = torch.sqrt((top & KEY_MASK).view(torch.float32).double()).float()
    return d, top & 0x1FFF
