"""Fused unpose (neighbour gather + gated blend + 4x4 warp): CUDA kernel
plus plain version, and the Morton codes that order the vertex table.

Counterpart of ``animnerf_tpu/ops/warp_blend.py::warp_blend_fwd_pallas``
with ``inputs_t=True, xyz_rows=True, warp_view=False``:
xyz rows (B, 8, N) [x|y|z|..], dists/idx (B, 4, N) as the top-4 kNN emits
them, table (B, V, num_lbs + 16) -> (out (B, 8, N) rows
[x'|y'|z'|bd|0 0 0 0], w (B, 4, N), bf (B, 16, N)). ``w`` and ``bf`` are the residuals the
training slice's backward will consume.
"""

from __future__ import annotations

import torch

from animnerf_tpu_torch.ops import _build
from animnerf_tpu_torch.ops.blend import gather_blend_plain

K = 4  # neighbours per point: the kNN's top-4


def morton_codes(verts: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) -> (B, V) int64 Morton (Z-order) codes, 10 bits per axis;
    the same values as the JAX package's uint32 codes."""
    lo = verts.amin(dim=1, keepdim=True)
    hi = verts.amax(dim=1, keepdim=True)
    q = torch.clamp((verts - lo) / (hi - lo + 1e-9) * 1023.0, 0.0,
                    1023.0).to(torch.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return (spread(q[..., 0]) | (spread(q[..., 1]) << 1)
            | (spread(q[..., 2]) << 2))


def _check(xyz_rows, dists, idx, table, num_lbs):
    B, k, N = idx.shape
    if k != K or xyz_rows.shape != (B, 8, N) or dists.shape != (B, K, N):
        raise ValueError(f"shapes: xyz_rows {tuple(xyz_rows.shape)}, dists "
                         f"{tuple(dists.shape)}, idx {tuple(idx.shape)}")
    if table.dim() != 3 or table.shape[0] != B \
            or table.shape[2] != num_lbs + 16:
        raise ValueError(f"table must be (B, V, {num_lbs + 16}), "
                         f"got {tuple(table.shape)}")
    if not (xyz_rows.dtype == dists.dtype == table.dtype == torch.float32
            and idx.dtype == torch.int32):
        raise ValueError("warp_blend takes float32 rows/dists/table and "
                         "int32 idx")


def warp_blend_fwd(xyz_rows: torch.Tensor, dists: torch.Tensor,
                   idx: torch.Tensor, table: torch.Tensor, num_lbs: int,
                   weight_std: float, conf_gate: float):
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    _check(xyz_rows, dists, idx, table, num_lbs)
    if xyz_rows.device.type == "cpu":
        return warp_blend_fwd_plain(xyz_rows, dists, idx, table, num_lbs,
                                    weight_std, conf_gate)
    xyz_rows, dists, idx, table = (t.contiguous() for t in
                                   (xyz_rows, dists, idx, table))
    _build.check_cuda("warp_blend_fwd", xyz_rows, dists, idx, table)
    B, _, N = idx.shape
    V, F = table.shape[1:]
    dev = xyz_rows.device
    out = torch.empty((B, 8, N), dtype=torch.float32, device=dev)
    w = torch.empty((B, K, N), dtype=torch.float32, device=dev)
    bf = torch.empty((B, 16, N), dtype=torch.float32, device=dev)
    if N == 0:
        return out, w, bf
    _build.kernel_library().call(
        "animnerf_warp_blend_fwd", xyz_rows.data_ptr(), dists.data_ptr(),
        idx.data_ptr(), table.data_ptr(), out.data_ptr(), w.data_ptr(),
        bf.data_ptr(), B, N, V, F, num_lbs,
        1.0 / (2.0 * float(weight_std) ** 2), float(conf_gate),
        _build.stream_of(xyz_rows))
    _build.LAUNCHES["warp_blend"] += 1
    return out, w, bf


def warp_blend_fwd_plain(xyz_rows, dists, idx, table, num_lbs: int,
                         weight_std: float, conf_gate: float):
    """gather_blend_plain plus the blended 4x4 applied to xyz."""
    _check(xyz_rows, dists, idx, table, num_lbs)
    B, _, N = idx.shape
    bd, bf, w = gather_blend_plain(table, dists.transpose(1, 2),
                                   idx.transpose(1, 2), num_lbs,
                                   weight_std, conf_gate)
    bf_t = bf.transpose(1, 2)                                # (B, 16, N)
    x, y, z = xyz_rows[:, 0:1], xyz_rows[:, 1:2], xyz_rows[:, 2:3]
    rows = [bf_t[:, 4 * r:4 * r + 1] * x + bf_t[:, 4 * r + 1:4 * r + 2] * y
            + bf_t[:, 4 * r + 2:4 * r + 3] * z + bf_t[:, 4 * r + 3:4 * r + 4]
            for r in range(3)]
    rows.append(bd.transpose(1, 2))
    rows.append(torch.zeros((B, 4, N), dtype=xyz_rows.dtype,
                            device=xyz_rows.device))
    return (torch.cat(rows, dim=1), w.transpose(1, 2).contiguous(),
            bf_t.contiguous())
