"""Plain neighbour gather + confidence-gated LBS blend (forward only).

Counterpart of ``animnerf_tpu/ops/blend.py::_gather_blend_impl``; the
warp-blend kernel's plain version (``ops/warp_blend.py``) is built on it.
The backward scatter (TPU kernel ``_scatter_kernel``) belongs to the
training slice.
"""

from __future__ import annotations

import torch


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
