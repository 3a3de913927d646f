"""Neighbour gather + confidence-gated LBS blend, and its backward: the
weighted row scatter (CUDA kernel plus plain version).

Counterpart of ``animnerf_tpu/ops/blend.py``: ``gather_blend_plain`` is
``_gather_blend_impl`` (the warp-blend kernel's plain version,
``ops/warp_blend.py``, is built on it), and ``weighted_scatter_rows`` is
``weighted_scatter_rows`` with ``transposed_in=True, g_t=True`` (the TPU
kernel ``_scatter_kernel``): the warp-blend backward into the table's 16
transform columns.
"""

from __future__ import annotations

import torch

from animnerf_tpu_torch.ops import _build

K = 4  # neighbours per point
F = 16  # transform columns


def gather_blend_plain(table: torch.Tensor, dists: torch.Tensor,
                       idx: torch.Tensor, num_lbs: int, weight_std: float,
                       conf_gate: float):
    """table (B, V, num_lbs + F), dists/idx (B, N, k) -> (blended_dist
    (B, N, 1), blended_flat (B, N, F), w (B, N, k)): weights exp(-d) gated
    by exp(-L1(lbs_k - lbs_0) / (2 std^2)) > conf_gate, normalised
    (reference anim_nerf.py:161-178)."""
    B, N, k = idx.shape
    Ft = table.shape[-1]
    g = torch.gather(table, 1, idx.reshape(B, N * k, 1).long()
                     .expand(B, N * k, Ft)).reshape(B, N, k, Ft)
    neigh_w = g[..., :num_lbs]
    neigh_T = g[..., num_lbs:]
    conf = torch.exp(
        -torch.sum(torch.abs(neigh_w - neigh_w[..., 0:1, :]), dim=-1)
        / (2.0 * weight_std ** 2))
    gate = (conf > conf_gate).to(dists.dtype)
    w = torch.exp(-dists) * gate
    w = w / torch.sum(w, dim=-1, keepdim=True)
    blended_flat = torch.einsum("bnk,bnkf->bnf", w, neigh_T)
    blended_dist = torch.sum(w * dists, dim=-1, keepdim=True)
    return blended_dist, blended_flat, w


def _check(idx_t, w_t, g, num_rows):
    B, k, N = idx_t.shape
    if k != K or w_t.shape != (B, K, N) or g.shape != (B, F, N):
        raise ValueError(f"idx/w (B, {K}, N) and g (B, {F}, N) expected, got "
                         f"{tuple(idx_t.shape)}, {tuple(w_t.shape)}, "
                         f"{tuple(g.shape)}")
    if idx_t.dtype != torch.int32 or w_t.dtype != torch.float32 \
            or g.dtype != torch.float32:
        raise ValueError("weighted scatter takes int32 idx, float32 w and g")
    if num_rows <= 0:
        raise ValueError(f"num_rows must be positive, got {num_rows}")


def weighted_scatter_rows(idx_t: torch.Tensor, w_t: torch.Tensor,
                          g: torch.Tensor, num_rows: int) -> torch.Tensor:
    """out[b, idx_t[b, k, n], :] += w_t[b, k, n] * g[b, :, n]: idx/w
    (B, 4, N) as the kNN emits them, g (B, 16, N) rows-native ->
    (B, num_rows, 16) float32. Kernel on CUDA tensors (f32 atomics: the
    summation order, and so the last bits, vary between runs), plain
    version on CPU tensors."""
    _check(idx_t, w_t, g, num_rows)
    if idx_t.device.type == "cpu":
        return weighted_scatter_rows_plain(idx_t, w_t, g, num_rows)
    idx_t, w_t, g = (t.detach().contiguous() for t in (idx_t, w_t, g))
    _build.check_cuda("weighted_scatter_rows", idx_t, w_t, g)
    B, _, N = idx_t.shape
    out = torch.zeros((B, num_rows, F), dtype=torch.float32,
                      device=idx_t.device)
    if N == 0:
        return out
    _build.kernel_library().call(
        "animnerf_weighted_scatter", idx_t.data_ptr(), w_t.data_ptr(),
        g.data_ptr(), out.data_ptr(), B, N, num_rows,
        _build.stream_of(idx_t))
    _build.LAUNCHES["scatter"] += 1
    return out


def weighted_scatter_rows_plain(idx_t: torch.Tensor, w_t: torch.Tensor,
                                g: torch.Tensor,
                                num_rows: int) -> torch.Tensor:
    """The same sum with ``index_add_`` over the flattened (B * num_rows)
    rows of the (4N, 16) contributions."""
    _check(idx_t, w_t, g, num_rows)
    B, _, N = idx_t.shape
    contrib = (w_t[:, :, None, :] * g[:, None, :, :])      # (B, 4, 16, N)
    contrib = contrib.permute(0, 1, 3, 2).reshape(B * K * N, F)
    rows = (idx_t.long() + (torch.arange(B, device=idx_t.device)
                            * num_rows)[:, None, None]).reshape(-1)
    out = torch.zeros((B * num_rows, F), dtype=g.dtype, device=g.device)
    out.index_add_(0, rows, contrib)
    return out.reshape(B, num_rows, F)
