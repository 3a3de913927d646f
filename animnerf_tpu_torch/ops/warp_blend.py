"""Fused unpose (neighbour gather + gated blend + 4x4 warp): CUDA kernel
plus plain version, its autograd Function, the point-layout entry, and
the Morton codes that order the vertex table.

Counterpart of ``animnerf_tpu/ops/warp_blend.py::warp_blend_fwd_pallas``
with ``inputs_t=True, xyz_rows=True``, ``warp_view`` off and on:
xyz rows (B, 8, N) [x|y|z|0|vx|vy|vz|0], dists/idx (B, k, N) as the top-k
kNN emits them (k = ``k_neigh``, any k >= 1, read from the shapes), table
(B, V, num_lbs + 16) -> (out (B, 8, N) rows [x'|y'|z'|bd|vd'|0] (vd' the
view direction warped by the blended 4x4, translation included, with
``warp_view``; zeros without), w (B, k, N), bf (B, 16, N)); of
``warp_blend_rows`` (its custom VJP): differentiable through the xyz
rows 0..2 (and 4..6 with ``warp_view``) and the table's 16 transform
columns, whose gradient is the weighted row scatter (``ops/blend.py``,
the backward kernel); the distances, the indices and the LBS-weight gate
are constants (the reference runs the kNN under no_grad and the gate is
a hard threshold); and of ``warp_blend`` (the point layout, which packs
the rows itself as ``xyz_rows=False`` does).

On the card, k up to ``WARP_GROUP_ABOVE`` runs the per-K thread kernels
and k above it the group kernel (``GROUP_LANES`` lanes a point, up to
``group_max_k``), whose outputs equal the thread route's; ``route=``
asks for either (``csrc/warp_blend.cu`` states both designs).
"""

from __future__ import annotations

import torch

from animnerf_tpu_torch.ops import _build
from animnerf_tpu_torch.ops.blend import (
    gather_blend_plain,
    weighted_scatter_rows,
)


# the k above which the warp-blend runs its group kernel (GROUP_LANES
# lanes a point: csrc/warp_blend.cu warp_blend_group_kernel) up to
# group_max_k, where its shared memory ends; up to it, and only there, the
# per-K thread kernels, and above group_max_k the run-time-k thread kernel.
# chip_smoke.py's "warp_routes" line times both routes at K = 8, 12, 16
# and 17 on a 2^20-point random-order cloud and on a 512^2 view's call in
# ray order (PERF.md §6, H100 80GB HBM3 at 700 W): the group kernel is the
# faster on both shapes from 17, at 16 on the random cloud only. (At 8
# lanes a point it measured slower on the view's call, PERF.md §6.)
WARP_GROUP_ABOVE = 16
GROUP_LANES = 4  # csrc/warp_blend.cu's G
ROUTES = (None, "thread", "group")
GROUP_SMEM = 232448  # a block's shared memory on the H100


def group_max_k(num_lbs: int) -> int:
    """The largest k the group kernel takes: its block of 256 threads
    holds 256 / GROUP_LANES points' neighbour-0 LBS float4s and 12 B
    (distance, index, weight) a neighbour a point in GROUP_SMEM bytes (the
    C entry animnerf_warp_blend_group_max_k reports the same)."""
    P = 256 // GROUP_LANES
    return (GROUP_SMEM - 16 * P * -(-num_lbs // 4)) // (12 * P)


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
    if k < 1 or xyz_rows.shape != (B, 8, N) or dists.shape != (B, k, N):
        raise ValueError(f"shapes (k must be at least 1): xyz_rows "
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


def warp_blend_row_layout(num_lbs: int) -> int:
    """Lp, the LBS part of a row as the CUDA kernel reads it: num_lbs
    rounded up to 4 floats, so that its rows [lbs | 0 .. | T] of Lp + 16
    floats and their transform part lie on 16 bytes (csrc/warp_blend.cu);
    a table whose num_lbs is already a multiple of 4 is read in place."""
    return -(-num_lbs // 4) * 4


def pad_table_plain(table: torch.Tensor, num_lbs: int) -> torch.Tensor:
    """The kernel's padded rows (warp_blend_pad_kernel): (B, V, num_lbs +
    16) -> (B, V, Lp + 16), the LBS part zero-padded to Lp floats."""
    Lp = warp_blend_row_layout(num_lbs)
    return torch.cat([torch.nn.functional.pad(table[..., :num_lbs],
                                              (0, Lp - num_lbs)),
                      table[..., num_lbs:]], dim=-1)


def group_route(route, k: int, num_lbs: int) -> bool:
    """Whether the warp-blend at k runs its group kernel: from
    WARP_GROUP_ABOVE + 1 to group_max_k for ``route=None``; "thread" asks
    for the thread kernels at any k, "group" for the group kernel up to
    group_max_k (the outputs are equal, up to the sign of a zero)."""
    top = group_max_k(num_lbs)
    if route not in ROUTES or (route == "group" and k > top):
        raise ValueError(f"route {route!r} does not take k={k}: one of "
                         f"{ROUTES}, the group kernel up to {top}")
    return route == "group" or (route is None
                                and WARP_GROUP_ABOVE < k <= top)


def warp_blend_fwd(xyz_rows: torch.Tensor, dists: torch.Tensor,
                   idx: torch.Tensor, table: torch.Tensor, num_lbs: int,
                   weight_std: float, conf_gate: float,
                   residuals: bool = True, warp_view: bool = False,
                   route: str = None):
    """Kernel on CUDA tensors, plain version on CPU tensors. -> (out, w,
    bf); with ``residuals=False`` (the no-grad callers) only out is
    written: (out, None, None). ``warp_view`` warps the view direction of
    rows 4:7 into out rows 4:7. ``route``: None picks the kernel by k
    (``group_route``), "thread" or "group" asks for one."""
    _check(xyz_rows, dists, idx, table, num_lbs)
    group = group_route(route, idx.shape[1], num_lbs)
    if xyz_rows.device.type == "cpu":
        return warp_blend_fwd_plain(xyz_rows, dists, idx, table, num_lbs,
                                    weight_std, conf_gate, residuals,
                                    warp_view)
    xyz_rows, dists, idx, table = (t.contiguous() for t in
                                   (xyz_rows, dists, idx, table))
    _build.check_cuda("warp_blend_fwd", xyz_rows, dists, idx, table)
    B, k, N = idx.shape
    V = table.shape[1]
    dev = xyz_rows.device
    out = torch.empty((B, 8, N), dtype=torch.float32, device=dev)
    w = bf = None
    if residuals:
        w = torch.empty((B, k, N), dtype=torch.float32, device=dev)
        bf = torch.empty((B, 16, N), dtype=torch.float32, device=dev)
    if N == 0:
        return out, w, bf
    Lp = warp_blend_row_layout(num_lbs)
    padded = None  # rows read in place when they lie on 16 bytes
    if Lp != num_lbs or table.data_ptr() % 16:
        padded = torch.empty((B, V, Lp + 16), dtype=torch.float32,
                             device=dev)
    # the group kernel's row summaries: each row's largest LBS weight and
    # its column
    summary = (torch.empty((B, V, 2), dtype=torch.float32, device=dev)
               if group else None)
    _build.kernel_library().call(
        "animnerf_warp_blend_fwd", xyz_rows.data_ptr(), dists.data_ptr(),
        idx.data_ptr(), table.data_ptr(),
        None if padded is None else padded.data_ptr(),
        None if summary is None else summary.data_ptr(), out.data_ptr(),
        w.data_ptr() if residuals else None,
        bf.data_ptr() if residuals else None, B, N, V, k, num_lbs,
        1.0 / (2.0 * float(weight_std) ** 2), float(conf_gate),
        int(bool(warp_view)), int(group),
        _build.stream_of(xyz_rows))
    _build.LAUNCHES["warp_blend"] += 1
    if group:
        _build.LAUNCHES["warp_blend_group"] += 1
    if warp_view:
        _build.LAUNCHES["warp_blend_view_dir"] += 1
    return out, w, bf


def warp_blend_fwd_plain(xyz_rows, dists, idx, table, num_lbs: int,
                         weight_std: float, conf_gate: float,
                         residuals: bool = True, warp_view: bool = False):
    """gather_blend_plain plus the blended 4x4 applied to xyz (and, with
    ``warp_view``, to the view direction of rows 4:7, translation
    included); (out, None, None) with ``residuals=False``."""
    _check(xyz_rows, dists, idx, table, num_lbs)
    B, _, N = idx.shape
    bd, bf, w = gather_blend_plain(table, dists.transpose(1, 2),
                                   idx.transpose(1, 2), num_lbs,
                                   weight_std, conf_gate)
    bf_t = bf.transpose(1, 2)                                # (B, 16, N)

    def apply(c0):
        x, y, z = (xyz_rows[:, c0 + c:c0 + c + 1] for c in range(3))
        return [bf_t[:, 4 * r:4 * r + 1] * x
                + bf_t[:, 4 * r + 1:4 * r + 2] * y
                + bf_t[:, 4 * r + 2:4 * r + 3] * z
                + bf_t[:, 4 * r + 3:4 * r + 4] for r in range(3)]

    rows = apply(0)
    rows.append(bd.transpose(1, 2))
    if warp_view:
        rows += apply(4)
    rows.append(torch.zeros((B, 1 if warp_view else 4, N),
                            dtype=xyz_rows.dtype, device=xyz_rows.device))
    out = torch.cat(rows, dim=1)
    if not residuals:
        return out, None, None
    return out, w.transpose(1, 2).contiguous(), bf_t.contiguous()


class WarpBlendRows(torch.autograd.Function):
    """Forward: the warp-blend kernel, saving w and bf. Backward: d_bf rows
    d_cano[r] * [x, y, z, 1][c] (plus d_vd[r] * [vx, vy, vz, 1][c] with
    ``warp_view``) scattered into the 16 transform columns by
    ``weighted_scatter_rows`` (zeros for the LBS columns), and d_xyz rows
    R^T d_cano (and R^T d_vd in rows 4:7 with ``warp_view``) from bf
    (counterpart of ops/warp_blend.py:333-371 and :398-439)."""

    @staticmethod
    def forward(ctx, xyz_rows, dists, idx, table, num_lbs, weight_std,
                conf_gate, warp_view=False):
        out, w, bf = warp_blend_fwd(xyz_rows.detach(), dists.detach(), idx,
                                    table.detach(), num_lbs, weight_std,
                                    conf_gate, warp_view=warp_view)
        ctx.save_for_backward(xyz_rows, idx, w, bf)
        ctx.table_shape = table.shape
        ctx.num_lbs = num_lbs
        ctx.warp_view = warp_view
        return out

    @staticmethod
    def backward(ctx, d_out):
        xyz_rows, idx, w, bf = ctx.saved_tensors
        B, _, N = xyz_rows.shape
        d_cano = d_out[:, 0:3]
        d_vd = d_out[:, 4:7] if ctx.warp_view else None
        d_xyz = d_table = None
        if ctx.needs_input_grad[3]:
            ones = xyz_rows.new_ones(B, 1, N)
            xyzh = torch.cat([xyz_rows[:, 0:3], ones], dim=1)
            parts = [d_cano[:, r:r + 1] * xyzh for r in range(3)]
            if d_vd is not None:
                vdh = torch.cat([xyz_rows[:, 4:7], ones], dim=1)
                parts = [p + d_vd[:, r:r + 1] * vdh
                         for r, p in enumerate(parts)]
            d_bf = torch.cat(parts + [xyz_rows.new_zeros(B, 4, N)], dim=1)
            V = ctx.table_shape[1]
            d_t16 = weighted_scatter_rows(idx, w, d_bf.contiguous(), V)
            d_table = torch.cat([d_t16.new_zeros(B, V, ctx.num_lbs), d_t16],
                                dim=-1)
        if ctx.needs_input_grad[0]:
            def r_t(d):
                rows = []
                for j in range(3):
                    acc = bf[:, j:j + 1] * d[:, 0:1]
                    acc = acc + bf[:, 4 + j:5 + j] * d[:, 1:2]
                    acc = acc + bf[:, 8 + j:9 + j] * d[:, 2:3]
                    rows.append(acc)
                return rows

            zero = xyz_rows.new_zeros(B, 1, N)
            rest = (r_t(d_vd) + [zero] if d_vd is not None
                    else [xyz_rows.new_zeros(B, 4, N)])
            d_xyz = torch.cat(r_t(d_cano) + [zero] + rest, dim=1)
        return d_xyz, None, None, d_table, None, None, None, None


def warp_blend_rows(xyz_rows: torch.Tensor, dists: torch.Tensor,
                    idx: torch.Tensor, table: torch.Tensor, num_lbs: int,
                    weight_std: float, conf_gate: float,
                    warp_view: bool = False) -> torch.Tensor:
    """(B, 8, N) rows [x'|y'|z'|bd|vd'|0] (vd' zeros without
    ``warp_view``), differentiable through the xyz (and view) rows and
    the table's transform columns when autograd needs it; without it the
    forward writes no residuals."""
    if torch.is_grad_enabled() and (xyz_rows.requires_grad
                                    or table.requires_grad):
        return WarpBlendRows.apply(xyz_rows, dists, idx, table, num_lbs,
                                   weight_std, conf_gate, warp_view)
    return warp_blend_fwd(xyz_rows, dists, idx, table, num_lbs, weight_std,
                          conf_gate, residuals=False, warp_view=warp_view)[0]


def warp_blend(xyz: torch.Tensor, viewdir, dists: torch.Tensor,
               idx: torch.Tensor, table: torch.Tensor, num_lbs: int,
               weight_std: float, conf_gate: float, warp_view: bool = False,
               inputs_t: bool = False):
    """The point layout (``animnerf_tpu/ops/warp_blend.py::warp_blend``):
    xyz (B, N, 3), viewdir (B, N, 3) or None, dists/idx (B, N, k), or
    (B, k, N) with ``inputs_t`` -> (xyz_cano (B, N, 3), viewdir_out,
    blended_dist (B, N, 1)). viewdir_out is the warped view direction
    with ``warp_view`` (of zeros when viewdir is None, as in the JAX
    package), else the input passed through.
    The rows [x|y|z|0|vx|vy|vz|0] are packed here, as
    ``warp_blend_fwd_pallas(xyz_rows=False)`` packs them, and go through
    ``warp_blend_rows``: the same kernel, the same gradients."""
    B, N = xyz.shape[:2]
    xyz_t = xyz.to(torch.float32).transpose(1, 2)
    zero = xyz_t.new_zeros(B, 1, N)
    if warp_view and viewdir is not None:
        vd_t = viewdir.to(torch.float32).transpose(1, 2)
    else:
        vd_t = xyz_t.new_zeros(B, 3, N)
    rows = torch.cat([xyz_t, zero, vd_t, zero], dim=1)
    if not inputs_t:
        dists, idx = dists.transpose(1, 2), idx.transpose(1, 2)
    out = warp_blend_rows(rows, dists.to(torch.float32).contiguous(),
                          idx.to(torch.int32).contiguous(), table, num_lbs,
                          weight_std, conf_gate, bool(warp_view))
    cano = out[:, 0:3].transpose(1, 2)
    bd = out[:, 3:4].transpose(1, 2)
    vd = out[:, 4:7].transpose(1, 2) if warp_view else viewdir
    return cano, vd, bd
