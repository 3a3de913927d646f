"""Survivor compaction as a permutation — counterpart of
``animnerf_tpu/ops/perm_sort.py``.

The rows-compacted training step moves survivor samples between the dense
(B, N) grid and the compacted (B, cap) working set. The JAX package
applies each permutation as a multi-operand sort (random gathers were
latency-bound on the TPU); on the GPU a gather by the permutation's index
is the direct form. The rank tables are the JAX package's exactly:

    keys = where(keep, iota, iota + N)       (or Morton codes, dropped last)
    o    = stable argsort(keys)   o[p]   = original index of rank p
    inv  = o's inverse            inv[i] = rank of original index i

Compaction gathers by ``o`` and slices ``[:cap]``; expansion pads with
the fill values and gathers by ``inv``. Both differentiate through one
``Permute`` Function whose backward gathers by the inverse permutation:
no ``index_add_``, deterministic.
"""

from __future__ import annotations

from typing import Sequence

import torch

from animnerf_tpu_torch.ops.warp_blend import spread_bits
from animnerf_tpu_torch.utils import trace


def _take(x: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """x gathered along ``dim`` by per-batch indices idx (B, n)."""
    shape = [1] * x.dim()
    shape[0], shape[dim] = idx.shape[0], idx.shape[1]
    size = list(x.shape)
    size[dim] = idx.shape[1]
    return torch.gather(x, dim, idx.reshape(shape).expand(size))


class Permute(torch.autograd.Function):
    """x gathered along ``dim`` by the permutation ``fwd`` (B, N); the
    backward gathers the cotangent by its inverse ``bwd``."""

    @staticmethod
    def forward(ctx, x, dim, fwd, bwd):
        ctx.dim = dim
        ctx.save_for_backward(bwd)
        return _take(x, dim, fwd)

    @staticmethod
    def backward(ctx, g):
        (bwd,) = ctx.saved_tensors
        return _take(g, ctx.dim, bwd), None, None, None


def permute(x: torch.Tensor, dim: int, fwd: torch.Tensor,
            bwd: torch.Tensor) -> torch.Tensor:
    return Permute.apply(x, dim, fwd, bwd)


def inverse_permutation(o: torch.Tensor) -> torch.Tensor:
    """inv with inv[..., o[..., p]] = p, along the last axis."""
    iota = torch.arange(o.shape[-1], device=o.device).expand_as(o)
    return torch.empty_like(o).scatter_(-1, o, iota)


def _morton_rows(px: torch.Tensor, py: torch.Tensor,
                 pz: torch.Tensor) -> torch.Tensor:
    """(B, N) coordinate rows -> (B, N) int64 Morton codes (10 bits per
    axis, per-row normalised; the same values as the JAX package's)."""
    out = torch.zeros(px.shape, dtype=torch.int64, device=px.device)
    for shift, p in enumerate((px, py, pz)):
        lo = p.amin(dim=1, keepdim=True)
        hi = p.amax(dim=1, keepdim=True)
        q = torch.clamp((p - lo) / (hi - lo + 1e-9) * 1023.0,
                        0.0, 1023.0).to(torch.int64)
        out = out | (spread_bits(q) << shift)
    return out


def compaction_ranks(keep: torch.Tensor, xyz_rows=None):
    """keep (B, N) bool -> (o, inv, n): o (B, N) int64 the original index
    of each rank (survivors first, in original order or, with
    ``xyz_rows`` = (px, py, pz), in Morton order; then the dropped ones in
    original order), inv (B, N) its inverse, n the largest per-row
    survivor count (a 0-d tensor: reading it is the caller's one sync).
    Span ``compact.prepass``."""
    with trace.span("compact.prepass"):
        B, N = keep.shape
        iota = torch.arange(N, device=keep.device).expand(B, N)
        if xyz_rows is None:
            keys = torch.where(keep, iota, iota + N)
        else:
            m = _morton_rows(*(p.detach() for p in xyz_rows))
            keys = torch.where(keep, m, torch.full_like(m, 0x7FFFFFFF))
        o = torch.argsort(keys, dim=1, stable=True)
        inv = inverse_permutation(o)
        n = keep.sum(dim=1).max() if B \
            else keep.new_zeros((), dtype=torch.int64)
        return o, inv, n


def compact_channels(vals: Sequence[torch.Tensor], o: torch.Tensor,
                     inv: torch.Tensor, cap: int):
    """Each (B, N) channel's first ``cap`` ranks -> (B, cap) channels
    (ranks past the survivor count hold dropped samples, not copies)."""
    x = permute(torch.stack(tuple(vals), dim=1), 2, o, inv)[:, :, :cap]
    return x.unbind(dim=1)


def expand_channels(vals_cap: Sequence[torch.Tensor], fills,
                    o: torch.Tensor, inv: torch.Tensor):
    """(B, cap) channels back to dense (B, N); ranks >= cap take the
    channel's fill value."""
    B, N = o.shape
    cap = vals_cap[0].shape[1]
    full = torch.stack([
        torch.cat([v, v.new_full((B, N - cap), fill)], dim=1)
        for v, fill in zip(vals_cap, fills)], dim=1)
    return permute(full, 2, inv, o).unbind(dim=1)
