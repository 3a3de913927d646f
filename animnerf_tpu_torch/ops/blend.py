"""Neighbour gather + confidence-gated LBS blend, and its backward: the
weighted row scatter (CUDA kernel plus plain version).

Counterpart of ``animnerf_tpu/ops/blend.py``: ``gather_blend_plain`` is
``_gather_blend_impl`` (the warp-blend kernel's plain version,
``ops/warp_blend.py``, is built on it), and ``weighted_scatter_rows`` is
``weighted_scatter_rows`` with ``transposed_in=True, g_t=True`` (the TPU
kernel ``_scatter_kernel``): the warp-blend backward into the table's 16
transform columns. k (the neighbour rows, ``k_neigh``) is read from the
shapes, any k >= 1.
"""

from __future__ import annotations

import torch

from animnerf_tpu_torch.ops import _build

F = 16  # transform columns


def gather_blend_plain(table: torch.Tensor, dists: torch.Tensor,
                       idx: torch.Tensor, num_lbs: int, weight_std: float,
                       conf_gate: float):
    """table (B, V, num_lbs + F), dists/idx (B, N, k) -> (blended_dist
    (B, N, 1), blended_flat (B, N, F), w (B, N, k)): weights exp(-d) gated
    by exp(-L1(lbs_k - lbs_0) / (2 std^2)) > conf_gate, normalised
    (reference anim_nerf.py:161-178). The sums over k run in order k = 0,
    1, ..., as the TPU kernel (warp_blend.py:98-109) and the CUDA kernel
    take them."""
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
    wsum = w[..., 0:1]
    for j in range(1, k):
        wsum = wsum + w[..., j:j + 1]
    w = w / wsum
    blended_flat = w[..., 0:1] * neigh_T[..., 0, :]
    blended_dist = w[..., 0:1] * dists[..., 0:1]
    for j in range(1, k):
        blended_flat = blended_flat + w[..., j:j + 1] * neigh_T[..., j, :]
        blended_dist = blended_dist + w[..., j:j + 1] * dists[..., j:j + 1]
    return blended_dist, blended_flat, w


def _check(idx_t, w_t, g, num_rows):
    B, k, N = idx_t.shape
    if k < 1 or w_t.shape != (B, k, N) or g.shape != (B, F, N):
        raise ValueError(f"idx/w (B, k >= 1, N) and g (B, {F}, N) "
                         f"expected, got {tuple(idx_t.shape)}, "
                         f"{tuple(w_t.shape)}, {tuple(g.shape)}")
    if idx_t.dtype != torch.int32 or w_t.dtype != torch.float32 \
            or g.dtype != torch.float32:
        raise ValueError("weighted scatter takes int32 idx, float32 w and g")
    if num_rows <= 0:
        raise ValueError(f"num_rows must be positive, got {num_rows}")


# the kernel's radix passes (csrc/scatter.cu): digits, tiles of ROUNDS x
# THREADS entries, each round ranked warp by warp
RADIX_BITS = 9
RADIX = 1 << RADIX_BITS
THREADS = 256
ROUNDS = 16
TILE = THREADS * ROUNDS


def radix_passes(num_keys: int) -> int:
    """The kernel's passes for keys in [0, num_keys): one per 9-bit digit
    of num_keys - 1, at least one."""
    bits = max(num_keys - 1, 0).bit_length()
    return max(1, -(-bits // RADIX_BITS))


def scatter_workspace_words(B: int, k: int, N: int, num_rows: int) -> int:
    """The kernel's scratch in 4-byte words (csrc/scatter.cu make_plan):
    prep keys, two ping-pong (key, n, w) buffers, the transposed
    cotangents, the digit counts and totals, the live count and each
    row's [begin, end), each region rounded up to 16 bytes."""
    def up4(x):
        return (x + 3) & ~3

    M = B * k * N
    tiles = -(-M // TILE)
    words = 0
    for size in (M, 2 * M, 4 * M, B * N * F, RADIX * tiles,
                 RADIX * radix_passes(B * num_rows), 1, 2 * B * num_rows):
        words = up4(words + size)
    return words


def scatter_order_plain(keys: torch.Tensor, num_keys: int):
    """Model of the kernel's placement: keys (M,) int, -1 for a dead
    entry, live keys in [0, num_keys). Each LSD pass over a 9-bit digit
    places an entry at the digit's base (the exclusive scan of the digit
    totals) + the tile's offset within the digit (the exclusive scan of
    the digit's per-tile counts) + the entries of that digit in the tile's
    earlier rounds + those in the round's earlier warps + those in earlier
    lanes of its warp, as scatter_place_kernel computes it. The first pass
    drops dead entries. Returns (the entry numbers in placed order, each
    key's [begin, end) in it, as scatter_bounds_kernel writes them: 0, 0
    for a key without entries)."""
    keys = keys.to(torch.int64).reshape(-1)
    ent = torch.arange(keys.numel(), dtype=torch.int64)
    for p in range(radix_passes(num_keys)):
        M = keys.numel()
        tiles = -(-M // TILE)
        pad = tiles * TILE - M
        kp = torch.cat([keys, keys.new_full((pad,), -1)])
        d = torch.where(kp >= 0, (kp >> (RADIX_BITS * p)) & (RADIX - 1),
                        RADIX)                      # RADIX: no slot
        dd = d.reshape(tiles, ROUNDS, THREADS // 32, 32)
        warp_id = torch.arange(tiles * ROUNDS * THREADS // 32)
        per_warp = torch.bincount(
            warp_id.repeat_interleave(32) * (RADIX + 1) + d,
            minlength=warp_id.numel() * (RADIX + 1)).reshape(
            tiles, ROUNDS, THREADS // 32, RADIX + 1)[..., :RADIX]
        lane_rank = ((dd[..., :, None] == dd[..., None, :])
                     & torch.ones(32, 32, dtype=torch.bool).tril(-1)
                     ).sum(-1)                      # earlier lanes, same d
        warp_pre = per_warp.cumsum(2) - per_warp
        per_round = per_warp.sum(2)
        round_pre = per_round.cumsum(1) - per_round
        hist = per_round.sum(1)                     # (tiles, R)
        tile_pre = hist.cumsum(0) - hist
        total = hist.sum(0)
        base = total.cumsum(0) - total
        live = d < RADIX
        dl = d[live]
        t, r, wp, ln = (torch.arange(tiles * TILE)[live] // TILE,
                        torch.arange(tiles * TILE)[live] % TILE // THREADS,
                        torch.arange(tiles * TILE)[live] % THREADS // 32,
                        torch.arange(tiles * TILE)[live] % 32)
        pos = (base[dl] + tile_pre[t, dl] + round_pre[t, r, dl]
               + warp_pre[t, r, wp, dl] + lane_rank[t, r, wp, ln])
        nk = torch.empty(int(live.sum()), dtype=torch.int64)
        ne = torch.empty_like(nk)
        nk[pos] = kp[live]
        ne[pos] = torch.cat([ent, ent.new_zeros(pad)])[live]
        keys, ent = nk, ne
    begin = torch.zeros(num_keys, dtype=torch.int64)
    end = torch.zeros(num_keys, dtype=torch.int64)
    L = keys.numel()
    if L:
        i = torch.arange(L)
        first = torch.ones(L, dtype=torch.bool)
        first[1:] = keys[1:] != keys[:-1]
        last = torch.ones(L, dtype=torch.bool)
        last[:-1] = keys[:-1] != keys[1:]
        begin[keys[first]] = i[first]
        end[keys[last]] = i[last] + 1
    return ent, begin, end


def sort_entries(idx_t: torch.Tensor, w_t: torch.Tensor, g: torch.Tensor,
                 num_rows: int):
    """The flattened keys b * num_rows + idx of the entries e = (b * k + j)
    * N + n of idx_t (B, k, N), stably sorted: (sorted keys int32, the
    entry of each sorted key int64). Both versions sum each row's entries
    in this order. An entry whose weight is 0 or whose point's cotangent
    column is all 0 adds an exact zero (a sum that starts at +0 never
    becomes -0, and x + 0 = x): it is keyed B * num_rows, past every row,
    so that gated-off neighbours and padded points make no row longer."""
    B = idx_t.shape[0]
    keys = (idx_t.to(torch.int32) + (torch.arange(
        B, dtype=torch.int32, device=idx_t.device) * num_rows)[:, None, None])
    live = (w_t != 0) & (g != 0).any(1, keepdim=True)
    keys = torch.where(live, keys, B * num_rows).reshape(-1)
    return torch.sort(keys, stable=True)


def weighted_scatter_rows(idx_t: torch.Tensor, w_t: torch.Tensor,
                          g: torch.Tensor, num_rows: int) -> torch.Tensor:
    """out[b, idx_t[b, k, n], :] += w_t[b, k, n] * g[b, :, n]: idx/w
    (B, k, N) as the kNN emits them, g (B, 16, N) rows-native ->
    (B, num_rows, 16) float32. Kernel on CUDA tensors, plain version on CPU
    tensors; both sum each row's contributions in the stable order of
    ``sort_entries`` (the kernel places the entries in that order with its
    own radix passes, modelled by ``scatter_order_plain``), so the result
    is bit-equal from run to run and between the two."""
    _check(idx_t, w_t, g, num_rows)
    if idx_t.device.type == "cpu":
        return weighted_scatter_rows_plain(idx_t, w_t, g, num_rows)
    idx_t, w_t, g = (t.detach().contiguous() for t in (idx_t, w_t, g))
    _build.check_cuda("weighted_scatter_rows", idx_t, w_t, g)
    B, k, N = idx_t.shape
    out = torch.empty((B, num_rows, F), dtype=torch.float32,
                      device=idx_t.device)
    if N == 0:
        return out.zero_()
    words = scatter_workspace_words(B, k, N, num_rows)
    if words >= 2 ** 31:
        raise ValueError(f"weighted scatter: a workspace of {words} words "
                         "is past the kernel's int32 sizes")
    ws = torch.empty(words, dtype=torch.int32, device=idx_t.device)
    _build.kernel_library().call(
        "animnerf_weighted_scatter", idx_t.data_ptr(), w_t.data_ptr(),
        g.data_ptr(), out.data_ptr(), ws.data_ptr(), words, B, N, num_rows,
        k, _build.stream_of(idx_t))
    _build.LAUNCHES["scatter"] += 1
    return out


def weighted_scatter_rows_plain(idx_t: torch.Tensor, w_t: torch.Tensor,
                                g: torch.Tensor,
                                num_rows: int) -> torch.Tensor:
    """The same sum in the kernel's order: the contributions w * g of the
    stably sorted entries, added to their row one position of the row's
    segment at a time (row segments longest first, so the rows still
    summing are a prefix)."""
    _check(idx_t, w_t, g, num_rows)
    B, k, N = idx_t.shape
    keys, perm = sort_entries(idx_t, w_t, g, num_rows)
    contrib = (w_t[:, :, None, :] * g[:, None, :, :])      # (B, k, 16, N)
    contrib = contrib.permute(0, 1, 3, 2).reshape(B * k * N, F)[perm]
    counts = torch.bincount(keys.long(), minlength=B * num_rows + 1)[:-1]
    starts = torch.cumsum(counts, 0) - counts
    by_len = torch.argsort(counts, descending=True, stable=True)
    live = torch.bincount(counts, minlength=1).flip(0).cumsum(0).flip(0)
    out = torch.zeros((B * num_rows, F), dtype=g.dtype, device=g.device)
    for j, n_live in enumerate(live[1:].tolist()):  # rows longer than j
        rows = by_len[:n_live]
        out[rows] = out[rows] + contrib[starts[rows] + j]
    return out.reshape(B, num_rows, F)
