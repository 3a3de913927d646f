"""Fused unpose (neighbour gather + gated blend + 4x4 warp): CUDA kernel
plus plain version, its autograd Function, and the Morton codes that order
the vertex table.

Counterpart of ``animnerf_tpu/ops/warp_blend.py::warp_blend_fwd_pallas``
with ``inputs_t=True, xyz_rows=True, warp_view=False``:
xyz rows (B, 8, N) [x|y|z|..], dists/idx (B, k, N) as the top-k kNN emits
them (k = ``k_neigh``, 1..16, read from the shapes), table
(B, V, num_lbs + 16) -> (out (B, 8, N) rows [x'|y'|z'|bd|0 0 0 0],
w (B, k, N), bf (B, 16, N)), and of
``warp_blend_rows`` (its custom VJP): differentiable through xyz rows
0..2 and the table's 16 transform columns, whose gradient is the weighted
row scatter (``ops/blend.py``, the backward kernel); the distances, the
indices and the LBS-weight gate are constants (the reference runs the kNN
under no_grad and the gate is a hard threshold).
"""

from __future__ import annotations

import torch

from animnerf_tpu_torch.ops import _build
from animnerf_tpu_torch.ops.blend import (
    MAX_K,
    gather_blend_plain,
    weighted_scatter_rows,
)


def spread_bits(x: torch.Tensor) -> torch.Tensor:
    """10-bit int64 values -> their bits spread to every third position
    (one axis of a Morton code)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(verts: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) -> (B, V) int64 Morton (Z-order) codes, 10 bits per axis;
    the same values as the JAX package's uint32 codes."""
    lo = verts.amin(dim=1, keepdim=True)
    hi = verts.amax(dim=1, keepdim=True)
    q = torch.clamp((verts - lo) / (hi - lo + 1e-9) * 1023.0, 0.0,
                    1023.0).to(torch.int64)
    return (spread_bits(q[..., 0]) | (spread_bits(q[..., 1]) << 1)
            | (spread_bits(q[..., 2]) << 2))


def _check(xyz_rows, dists, idx, table, num_lbs):
    B, k, N = idx.shape
    if not 1 <= k <= MAX_K or xyz_rows.shape != (B, 8, N) \
            or dists.shape != (B, k, N):
        raise ValueError(f"shapes (k must be in 1..{MAX_K}): xyz_rows "
                         f"{tuple(xyz_rows.shape)}, dists "
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
    B, k, N = idx.shape
    V, F = table.shape[1:]
    dev = xyz_rows.device
    out = torch.empty((B, 8, N), dtype=torch.float32, device=dev)
    w = torch.empty((B, k, N), dtype=torch.float32, device=dev)
    bf = torch.empty((B, 16, N), dtype=torch.float32, device=dev)
    if N == 0:
        return out, w, bf
    _build.kernel_library().call(
        "animnerf_warp_blend_fwd", xyz_rows.data_ptr(), dists.data_ptr(),
        idx.data_ptr(), table.data_ptr(), out.data_ptr(), w.data_ptr(),
        bf.data_ptr(), B, N, V, F, k, num_lbs,
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


class WarpBlendRows(torch.autograd.Function):
    """Forward: the warp-blend kernel, saving w and bf. Backward: d_bf rows
    d_cano[r] * [x, y, z, 1][c] scattered into the 16 transform columns by
    ``weighted_scatter_rows`` (zeros for the LBS columns), and d_xyz rows
    R^T d_cano from bf (counterpart of ops/warp_blend.py:398-439)."""

    @staticmethod
    def forward(ctx, xyz_rows, dists, idx, table, num_lbs, weight_std,
                conf_gate):
        out, w, bf = warp_blend_fwd(xyz_rows.detach(), dists.detach(), idx,
                                    table.detach(), num_lbs, weight_std,
                                    conf_gate)
        ctx.save_for_backward(xyz_rows, idx, w, bf)
        ctx.table_shape = table.shape
        ctx.num_lbs = num_lbs
        return out

    @staticmethod
    def backward(ctx, d_out):
        xyz_rows, idx, w, bf = ctx.saved_tensors
        B, _, N = xyz_rows.shape
        d_cano = d_out[:, 0:3]
        d_xyz = d_table = None
        if ctx.needs_input_grad[3]:
            xyzh = torch.cat([xyz_rows[:, 0:3], xyz_rows.new_ones(B, 1, N)],
                             dim=1)
            d_bf = torch.cat([d_cano[:, r:r + 1] * xyzh for r in range(3)]
                             + [xyz_rows.new_zeros(B, 4, N)], dim=1)
            V = ctx.table_shape[1]
            d_t16 = weighted_scatter_rows(idx, w, d_bf.contiguous(), V)
            d_table = torch.cat([d_t16.new_zeros(B, V, ctx.num_lbs), d_t16],
                                dim=-1)
        if ctx.needs_input_grad[0]:
            rows = []
            for j in range(3):
                acc = bf[:, j:j + 1] * d_cano[:, 0:1]
                acc = acc + bf[:, 4 + j:5 + j] * d_cano[:, 1:2]
                acc = acc + bf[:, 8 + j:9 + j] * d_cano[:, 2:3]
                rows.append(acc)
            d_xyz = torch.cat(rows + [xyz_rows.new_zeros(B, 5, N)], dim=1)
        return d_xyz, None, None, d_table, None, None, None


def warp_blend_rows(xyz_rows: torch.Tensor, dists: torch.Tensor,
                    idx: torch.Tensor, table: torch.Tensor, num_lbs: int,
                    weight_std: float, conf_gate: float) -> torch.Tensor:
    """(B, 8, N) rows [x'|y'|z'|bd|0..], differentiable through the xyz
    rows and the table's transform columns when autograd needs it."""
    if torch.is_grad_enabled() and (xyz_rows.requires_grad
                                    or table.requires_grad):
        return WarpBlendRows.apply(xyz_rows, dists, idx, table, num_lbs,
                                   weight_std, conf_gate)
    return warp_blend_fwd(xyz_rows, dists, idx, table, num_lbs, weight_std,
                          conf_gate)[0]
