"""Models of the run-time-k kNN kernels' selection (``csrc/knn_wide.cuh``,
``knn_packed_wide`` in ``csrc/knn_packed.cu``, ``knn_exact_wide`` in
``csrc/knn_exact.cu``), step for step, in numpy.

The kernels' outputs are held bit for bit against the plain versions in
``ops/knn_kernel.py`` on the card; these models show on the CPU that the
steps the plain versions do not have (the lane-strided bitonic networks,
the buffer and its folds, kernel 8's nearest-first tiles and their key
bound, kernel 9's nearest-first pass and its tie test, the per-point cull,
the slot list sorted by (d2 descending, slot ascending) and its merge, the
final sort by (d2, slot)) give the plain versions' output. A list of n =
32R keys is an (R, 32) array: element e = lane + 32 r at [r, lane], as in
the kernels' registers. Used by tests only.
"""

from __future__ import annotations

import numpy as np
import torch

from animnerf_tpu_torch.ops import knn_kernel as kk

CAP = 128  # knn_wide::CAP
PACKED_BIGKEY = 0x7FFFFFFF
NO_KEY = np.iinfo(np.int64).max  # above every (d2 bits, index) key


def regs_for(k: int) -> int:
    """knn_wide::regs_for: registers a lane holds for 32R >= k slots."""
    return 1 if k <= 32 else 2 if k <= 64 else 4


def _index(R: int) -> np.ndarray:
    return np.arange(32)[None, :] + 32 * np.arange(R)[:, None]


def stage(v, size: int, stride: int, pay=None):
    """One compare-exchange stage of knn_wide::stage: element e against
    e ^ stride, ascending where e & size is 0; the payload moves along."""
    e = _index(v.shape[0])
    flat = v.reshape(-1)
    o = flat[e ^ stride]
    up = (e & size) == 0
    lower = (e & stride) == 0
    take = np.where(lower == up, o < v, v < o)
    out = np.where(take, o, v)
    if pay is None:
        return out
    return out, np.where(take, pay.reshape(-1)[e ^ stride], pay)


def bitonic_sort(v, pay=None):
    """knn_wide::bitonic_sort: the lane-strided list ascending."""
    n = v.size
    size = 2
    while size <= n:
        stride = size // 2
        while stride > 0:
            if pay is None:
                v = stage(v, size, stride)
            else:
                v, pay = stage(v, size, stride, pay)
            stride //= 2
        size *= 2
    return v if pay is None else (v, pay)


def fold(a, b):
    """knn_wide::fold: the n smallest of two ascending lists, ascending
    (element e against b's element n - 1 - e, then the merge stages)."""
    n = a.size
    rev = b.reshape(-1)[n - 1 - _index(a.shape[0])]
    c = np.minimum(a, rev)
    stride = n // 2
    while stride > 0:
        c = stage(c, 2 * n, stride)
        stride //= 2
    return c


def _load_buffer(buf: list, R: int, sentinel: int) -> np.ndarray:
    b = np.full(32 * R, sentinel, dtype=np.int64)
    b[:len(buf)] = buf
    return b.reshape(R, 32)


def packed_keys(points: np.ndarray, rows: torch.Tensor,
                order: torch.Tensor) -> np.ndarray:
    """(N, Vp) packed keys of the points against rows in visiting order
    (knn_keys.cuh's dot form, each operation rounded on its own)."""
    tp = torch.from_numpy(np.ascontiguousarray(points, np.float32))
    r = rows[0]
    px, py, pz = tp[:, 0:1], tp[:, 1:2], tp[:, 2:3]
    pp = px * px + py * py + pz * pz
    s = r[:, 2] * pz + (r[:, 1] * py + (r[:, 0] * px + r[:, 3]))
    d2 = torch.clamp_min(pp + s, 0.0)
    return ((d2.view(torch.int32) & kk.KEY_MASK) | order).numpy()


def box_key_bound(p: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """knn_packed.cu box_key_bound of point p against boxes (M, 8): the
    box distance less the dot form's rounding, in key space (float32, each
    operation rounded on its own; the card contracts some into FMAs, which
    the 2^-18 margins cover)."""
    f = np.float32
    p = p.astype(f)
    with np.errstate(invalid="ignore", over="ignore"):
        pp = (p[0] * p[0] + p[1] * p[1]) + p[2] * p[2]
        g = [np.maximum(np.maximum(boxes[:, a] - p[a], p[a] - boxes[:, 3 + a]),
                        f(0)) for a in range(3)]
        lb2 = (g[0] * g[0] + g[1] * g[1]) + g[2] * g[2]
        vv = sum(np.maximum(boxes[:, a] * boxes[:, a],
                            boxes[:, 3 + a] * boxes[:, 3 + a])
                 for a in range(3))
        r = (np.sqrt(pp) + np.sqrt(vv)) * f(1 + 2.0 ** -18)
        lb = lb2 * f(1 - 2.0 ** -18) - f(5e-7) * r * r
    return np.where(lb > 0, lb.astype(f).view(np.int32) & kk.KEY_MASK, 0)


def packed_wide_model(points: np.ndarray, verts: np.ndarray, k: int):
    """``knn_packed_wide`` on points (N, 3) and verts (V, 3), V <= 8192:
    (dists (k, N), idx (k, N) int32, folds, swept pairs). Each point
    sweeps the Morton tiles (rows bit-reversed inside) in ascending order
    of their key bound, until a tile's bound exceeds the list's k-th key,
    32 rows a step (lane l the row at l); the lanes whose key is below the
    k-th append it in lane order, a buffer that would overflow is folded
    first (and the row-step's keys filtered again), and at a tile's end."""
    tv = torch.from_numpy(np.ascontiguousarray(verts, np.float32))[None]
    rows, order = kk.vertex_rows_plain(tv, stratified=False)
    keys = packed_keys(points, rows, order)
    boxes = kk.tile_boxes(tv)[0].numpy()
    R = regs_for(k)
    ns = 32 * R
    N, Vp = keys.shape
    V = len(verts)
    tile = kk.TILE_V
    out = np.zeros((k, N), np.int64)
    folds = swept = 0

    def fold_in(top, buf):
        nonlocal folds
        folds += 1
        return fold(top, bitonic_sort(_load_buffer(buf, R, PACKED_BIGKEY)))

    for n in range(N):
        top, buf = np.full((R, 32), PACKED_BIGKEY, np.int64), []
        bound = box_key_bound(points[n], boxes)
        for o in np.sort(bound | np.arange(len(boxes))):
            if o & kk.KEY_MASK > top.reshape(-1)[k - 1]:
                break
            t0 = int(o & 31) * tile
            swept += min(tile, V - t0)
            for j in range(t0, t0 + tile, 32):
                step = keys[n, j:j + 32]
                take = step < top.reshape(-1)[k - 1]
                if not take.any():
                    continue
                if len(buf) + int(take.sum()) > ns:
                    top, buf = fold_in(top, buf), []
                    take &= step < top.reshape(-1)[k - 1]
                buf.extend(int(x) for x in step[take])
            if buf:
                top, buf = fold_in(top, buf), []
        out[:, n] = top.reshape(-1)[:k]
    d = kk.ieee_sqrt(torch.from_numpy(
        (out & kk.KEY_MASK).astype(np.int32)).view(torch.float32))
    return d.numpy(), (out & 0x1FFF).astype(np.int32), folds, swept


def _rounded_lb2(p: np.ndarray, box: np.ndarray) -> np.ndarray:
    """knn_exact.cu rounded_lb2 of point p against boxes (M, 8), each
    operation rounded on its own in float32."""
    f = np.float32
    with np.errstate(invalid="ignore", over="ignore"):
        g = [np.maximum(np.maximum(box[:, a] - f(p[a]),
                                   f(p[a]) - box[:, 3 + a]), f(0))
             for a in range(3)]
        return (g[0] * g[0] + g[1] * g[1]) + g[2] * g[2]


def _fold_keys(T, buf, R, sentinel):
    return fold(T, bitonic_sort(_load_buffer(buf, R, sentinel)))


def _select(T, buf, keys, ok, ns, R, rank):
    """The buffer-and-fold of one row-step: the lanes whose key passes
    ``ok`` (given the list's key of that rank) append it, the buffer folded
    first if it would overflow. Returns (T, buf)."""
    take = ok(int(T.reshape(-1)[rank - 1]))
    if not take.any():
        return T, buf
    if len(buf) + int(take.sum()) > ns:
        T, buf = _fold_keys(T, buf, R, NO_KEY), []
        take &= ok(int(T.reshape(-1)[rank - 1]))
    return T, buf + [int(x) for x in keys[take]]


def _d2_of(key) -> np.float32:
    return np.int32(int(key) >> 32).view(np.float32)


def exact_nearest_pass(d2n, lb2_tile, lb2_sub, k: int, R: int):
    """``knn_exact_wide``'s first pass for one point: its k + 1 smallest
    (d2, index) keys, the tiles visited nearest first (ascending by their
    rounded box bound with 5 low bits cleared, then by index) until a
    tile's bound exceeds the (k+1)-th d2, sub-tiles above it skipped; the
    buffer folded when it would overflow and at each tile's end. Returns
    (list (32R,), swept pairs, tie-free), tie-free when the first k + 1
    d2 strictly ascend (then the slot rule's output is the first k)."""
    V = len(d2n)
    ns, tile, sub = 32 * R, kk.SLOT_TILE, kk.SUB_TILE
    nt = len(lb2_tile)
    o = np.sort((lb2_tile.view(np.int32).astype(np.int64) & ~31)
                | np.arange(nt))
    T, buf, swept = np.full((R, 32), NO_KEY, np.int64), [], 0
    for oi in o:
        tkd = _d2_of(T.reshape(-1)[k]) if T.reshape(-1)[k] != NO_KEY \
            else np.float32(np.inf)
        if np.int32(oi & ~31).view(np.float32) > tkd:
            break
        t0 = int(oi & 31) * tile
        rows_t = min(tile, V - t0)
        subs = [s for s in range(-(-rows_t // sub))
                if not lb2_sub[t0 // sub + s] > tkd]
        swept += sum(min(sub, rows_t - s * sub) for s in subs)
        for s in subs:
            for j in range(t0 + s * sub, min(t0 + (s + 1) * sub, V), 32):
                dj = d2n[j:min(j + 32, V)]
                keys = ((dj.view(np.int32).astype(np.int64) << 32)
                        | np.arange(j, j + len(dj)))
                T, buf = _select(T, buf, keys, lambda tk: keys < tk, ns,
                                    R, k + 1)
        if buf:
            T, buf = _fold_keys(T, buf, R, NO_KEY), []
    d = (T.reshape(-1)[:k + 1] >> 32).astype(np.int32).view(np.float32)
    tie_free = bool(np.all(T.reshape(-1)[:k + 1] != NO_KEY)
                    and np.all(d[:-1] < d[1:]))
    return T, swept, tie_free


def exact_wide_model(points: np.ndarray, verts: np.ndarray, k: int,
                     cull: bool = True):
    """``knn_exact_wide`` on points (N, 3) and verts (V, 3): (dists (k, N),
    idx (k, N) int32, swept, skipped, slot_rule) with its stats (real pairs
    of both passes) and the number of points the slot rule took. First
    ``exact_nearest_pass`` (when k + 1 <= 32R); a tie-free point takes its
    first k. The others, per 512-vertex tile in index order: the sub-tiles
    whose rounded lb2 is not above the slot maximum are swept (all with
    cull off), 32 rows a step in index order; pairs below the maximum and
    the tile list's k-th key go to the buffer, folded into the tile list
    when it would overflow and at the end; the list's pairs replace the
    slot list's elements while below them (the i-th against element i),
    the slot list sorted again. Then the sort by (d2 bits, slot)."""
    tp = torch.from_numpy(np.ascontiguousarray(points, np.float32))[None]
    tv = torch.from_numpy(np.ascontiguousarray(verts, np.float32))[None]
    d2 = kk.exact_d2(tp, tv)[0].numpy()
    _, sbox, tbox = (b[0].numpy() for b in kk.exact_rows_plain(tv))
    N, V = d2.shape
    R = regs_for(k + 1) if k < CAP else regs_for(k)
    ns = 32 * R
    e = np.arange(ns)
    sub, tile = kk.SUB_TILE, kk.SLOT_TILE
    out_d = np.zeros((k, N), np.float32)
    out_i = np.zeros((k, N), np.int32)
    swept = skipped = slot_rule = 0
    for n in range(N):
        lb2 = _rounded_lb2(points[n], sbox)
        if k + 1 <= ns and len(tbox) <= 32:
            T, sw, tie_free = exact_nearest_pass(
                d2[n], _rounded_lb2(points[n], tbox), lb2, k, R)
            swept += sw
            skipped += V - sw
            if tie_free:
                out_d[:, n] = (T.reshape(-1)[:k] >> 32).astype(
                    np.int32).view(np.float32)
                out_i[:, n] = (T.reshape(-1)[:k] & 0xFFFFFFFF).astype(np.int32)
                continue
        slot_rule += 1
        # the slot list: ascending (~d2 bits, slot); NO_KEY past k
        h = np.where(e < k, ((~np.int64(np.float32(np.inf).view(np.int32))
                              & 0xFFFFFFFF) << 32) | e, NO_KEY)
        hv = np.zeros(ns, np.int64)
        for t0 in range(0, V, tile):
            rows_t = min(tile, V - t0)
            smax = np.int32(~int(h[0] >> 32) & 0xFFFFFFFF).view(np.float32) \
                if h[0] != NO_KEY else np.float32(-np.inf)
            subs = [s for s in range(-(-rows_t // sub))
                    if not cull or not lb2[t0 // sub + s] > smax]
            rows_s = sum(min(sub, rows_t - s * sub) for s in subs)
            swept += rows_s
            skipped += rows_t - rows_s
            T, buf = np.full((R, 32), NO_KEY, np.int64), []
            for s in subs:
                for j in range(t0 + s * sub, t0 + (s + 1) * sub, 32):
                    dj = d2[n, j:min(j + 32, V)]
                    key = ((dj.view(np.int32).astype(np.int64) << 32)
                           | np.arange(j, j + len(dj)))
                    T, buf = _select(T, buf, key,
                                        lambda tk: (dj < smax) & (key < tk),
                                        ns, R, k)
            if buf:
                T = _fold_keys(T, buf, R, NO_KEY)
            c = T.reshape(-1)
            cd = (c >> 32).astype(np.int32).view(np.float32)
            hd = np.where(h != NO_KEY, (~(h >> 32) & 0xFFFFFFFF).astype(
                np.uint32).view(np.float32), np.float32(np.nan))
            merge = (c != NO_KEY) & (h != NO_KEY) & (cd < hd)
            if merge.any():
                h = np.where(merge, ((~cd.view(np.int32).astype(np.int64)
                                      & 0xFFFFFFFF) << 32) | (h & 0xFFFFFFFF),
                             h)
                hv = np.where(merge, c & 0xFFFFFFFF, hv)
                hs, hvs = bitonic_sort(h.reshape(R, 32), hv.reshape(R, 32))
                h, hv = hs.reshape(-1), hvs.reshape(-1)
        slot = h & 0xFFFFFFFF
        hd = (~(h >> 32) & 0xFFFFFFFF).astype(np.uint32).view(np.float32)
        key = np.where(h != NO_KEY,
                       (hd.view(np.int32).astype(np.int64) << 32) | slot,
                       NO_KEY).reshape(R, 32)
        key, vid = bitonic_sort(key, hv.reshape(R, 32))
        out_d[:, n] = (key.reshape(-1)[:k] >> 32).astype(np.int32).view(
            np.float32)
        out_i[:, n] = vid.reshape(-1)[:k]
    d = kk.ieee_sqrt(torch.from_numpy(out_d)).numpy()
    return d, out_i, swept, skipped, slot_rule
