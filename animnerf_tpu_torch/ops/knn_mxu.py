"""Matmul-form top-4 nearest vertices (the kNN benchmark tool's variant):
a CUDA kernel on the tensor cores plus its plain version.

Counterpart of ``tools/bench_knn.py::knn_mxu`` (its kernel
``_mxu_knn_kernel``): points (B, N, 3), vertices (B, V, 3) -> dists
(B, N, 4), idx (B, N, 4), with d2 as one (V, 8) x (8, N) product of
augmented rows. As in the JAX tool, both clouds are centred on the
vertices' mean (the matmul form cancels in proportion to |p|^2 and
|v|^2) and the rows are built in plain torch ops: points ``[x, y, z,
|p|^2, 1, 0, 0, 0]``, vertices ``[-2x, -2y, -2z, 1, |v|^2, 0, 0, 0]``.

The plain version (``knn_mxu_plain``, the reference) sums the 8 products
left to right, each product and sum rounded on its own;
``precision="default"`` first rounds both operands to bf16 (to nearest
even), which is what the TPU's single-pass ``Precision.DEFAULT`` product
computes, ``"highest"`` keeps f32. Its top-4 follows the TPU kernel's slot
rule (``knn_kernel.tile_slots_topk``) and the distances are ``sqrt(max(d2,
0))``.

The kernel (``csrc/knn_mxu.cu``) takes the 5 live columns as bf16
operands in the tensor cores' fragment order, points and vertices in
Morton order (``mxu_operands``, its plain version; on the card
``mxu_operands_cuda`` packs them by two kernels): rounded to bf16 at
"default" (depth 16), split into bf16 hi + mid + lo at "highest" with the
six cross products a TPU takes for HIGHEST (depth 32). The tensor core
sums exact products in its own order, and the kernel keeps the top 4 by
(d2, input index). So it is not bit-equal to the plain version; it is
held to it (``chip_smoke.py``, ``mxu_check``) by

(a) the sorted distances, slot by slot, squared, within ``eps`` of the
    plain version's (a k-th smallest value moves by at most the largest
    perturbation of the d2s, so this holds where indices swap), and
(b) an index differing from the plain version's only where the plain
    d2s of the two candidates lie within 2 ``eps`` of each other,

with ``eps = 2^-19 (|p| + max |v|)^2`` a point (``mxu_eps``; centred
coordinates). Its derivation, in units of u = 2^-24 and of S = sum_j
|a_j b_j| over the live columns, S <= (|p| + |v|)^2 by Cauchy-Schwarz:
the plain version's left-to-right sum of 8 rounded products is within 8u
S of the exact product of its operands (7u at "default", whose products
are exact); the 3-way split drops mid.lo, lo.mid, lo.lo and the split's
remainder, each at most u |x y|: 4u S; the tensor core adds exact
products and, at most twice a depth-16 product, truncates an addend to
the largest one's 24 bits: 4u S a product, 8u S at "highest". That is 20u
S at "highest" and 11u at "default", below eps = 32u (|p| + |v|max)^2.
"""

from __future__ import annotations

import numpy as np
import torch

from animnerf_tpu_torch.ops import _build
from animnerf_tpu_torch.ops.knn_kernel import (
    check_points_verts,
    ieee_sqrt,
    tile_slots_topk,
)
from animnerf_tpu_torch.ops.warp_blend import spread_bits

K = 4  # the tool's k (its kernel's sorting network is the k=4 one)
PRECISIONS = ("highest", "default")
DEPTH = {"default": 16, "highest": 32}  # the packed product's depth
LIVE = {"default": 5, "highest": 30}  # its live bf16 products a pair
EPS_SCALE = 2.0 ** -19  # eps = EPS_SCALE (|p| + max |v|)^2 on d2
NO_INDEX = 0x7FFFFFFF  # an empty slot's index (csrc/knn_mxu.cu)
BLOCK_POINTS = 256  # a kernel block's points, TILES tiles of 16 a warp
TILES = 4  # csrc/knn_mxu.cu knn_mxu_mma_kernel's R
STAGE_VERTS = 256  # a shared-memory stage's vertices: 32 tiles of 8


def _norm2(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (x^2 + y^2) + z^2, each operation rounded on its own
    (the order csrc/knn_mxu.cu's packing kernel takes)."""
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) \
        + x[..., 2] * x[..., 2]


def augmented_rows(points: torch.Tensor, verts: torch.Tensor):
    """(B, N, 3), (B, V, 3) -> (P (B, 8, N), A (B, V, 8)) float32, centred
    on the per-batch vertex mean (bench_knn.py:87-108)."""
    c = verts.mean(dim=1, keepdim=True)
    p = points - c
    v = verts - c
    p2, v2 = _norm2(p), _norm2(v)
    one_p, zero_p = torch.ones_like(p2), torch.zeros_like(p2)
    one_v, zero_v = torch.ones_like(v2), torch.zeros_like(v2)
    P = torch.stack([p[..., 0], p[..., 1], p[..., 2], p2, one_p, zero_p,
                     zero_p, zero_p], dim=1)
    A = torch.stack([-2 * v[..., 0], -2 * v[..., 1], -2 * v[..., 2], one_v,
                     v2, zero_v, zero_v, zero_v], dim=2)
    return P.contiguous(), A.contiguous()


def split3(x: torch.Tensor):
    """float32 -> bf16 (hi, mid, lo), each the bf16 rounding of what the
    parts before it leave (every remainder is exact in float32)."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def _morton(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """(B, M, 3) -> (B, M) int64 Morton codes, 10 bits an axis, of x in the
    box [lo, hi]."""
    q = torch.clamp((x - lo) / (hi - lo + 1e-9) * 1023.0, 0.0,
                    1023.0).to(torch.int64)
    return (spread_bits(q[..., 0]) | (spread_bits(q[..., 1]) << 1)
            | (spread_bits(q[..., 2]) << 2))


def morton_box(points: torch.Tensor, verts: torch.Tensor):
    """(lo, hi) (B, 3): the box of both clouds, the Morton codes' range."""
    lo = torch.minimum(points.amin(1), verts.amin(1)).contiguous()
    hi = torch.maximum(points.amax(1), verts.amax(1)).contiguous()
    return lo, hi


def mxu_operands(points: torch.Tensor, verts: torch.Tensor,
                 precision: str):
    """The kernel's inputs: (pf (B, Mt, 32, 8 KC), vf (B, T, 32, 4 KC))
    bf16 operands in the fragment order of mma.m16n8k16 (row.col), Mt =
    ceil(N / 16), T = ceil(V / 8), KC = depth / 16, zero-padded; vidx (B, 8
    T) and pidx (B, 16 Mt) int32, the input index of each vertex and point
    position (NO_INDEX past V); first (B, blocks) int32, each block's first
    vertex stage. Points and vertices go in Morton order (10 bits an axis
    in the box of both centred clouds), so that a block's 256 points lie
    together and start at the stage of STAGE_VERTS vertices holding their
    middle point's code. Point rows are the 5 live columns [x, y, z,
    |p|^2, 1] of ``augmented_rows``, vertex rows [-2x, -2y, -2z, 1,
    |v|^2]: rounded to bf16 at "default" (depth 16); at "highest" (depth
    32) [p_hi, p_hi, p_mid, p_hi, p_mid, p_lo] against [v_hi, v_mid, v_hi,
    v_lo, v_mid, v_hi] (``split3``). Lane g * 4 + q of point tile m holds,
    per 16 columns c, the A fragment (rows g, g + 8; columns 2q, 2q + 1,
    2q + 8, 2q + 9) as a0 a1 (row g) a2 a3 (row g + 8) a4 a5 (row g, + 8
    columns) a6 a7; of vertex tile t the B fragment (vertex 8t + g;
    columns 2q, 2q + 1, then + 8)."""
    P, A = augmented_rows(points, verts)
    lo, hi = morton_box(points, verts)
    pcode, porder = _morton(points, lo[:, None], hi[:, None]).sort(
        dim=1, stable=True)
    vcode, vorder = _morton(verts, lo[:, None], hi[:, None]).sort(
        dim=1, stable=True)
    p5 = torch.gather(P[:, :5].transpose(1, 2), 1,
                      porder[..., None].expand(-1, -1, 5))    # (B, N, 5)
    v5 = torch.gather(A[..., :5], 1, vorder[..., None].expand(-1, -1, 5))
    if precision == "default":
        pa, va = p5.to(torch.bfloat16), v5.to(torch.bfloat16)
    else:
        ph, pm, pl = split3(p5)
        vh, vm, vl = split3(v5)
        pa = torch.cat([ph, ph, pm, ph, pm, pl], dim=-1)
        va = torch.cat([vh, vm, vh, vl, vm, vh], dim=-1)
    D = DEPTH[precision]
    KC = D // 16
    B, N, V = points.shape[0], points.shape[1], verts.shape[1]
    Mt, T = -(-N // 16), -(-V // 8)
    pa = torch.nn.functional.pad(pa, (0, D - pa.shape[-1], 0, Mt * 16 - N))
    va = torch.nn.functional.pad(va, (0, D - va.shape[-1], 0, T * 8 - V))
    # rows h 8 + g, columns c 16 + ch 8 + q 2 + pair -> (g, q, c, ch, h, pair)
    pf = pa.view(B, Mt, 2, 8, KC, 2, 4, 2).permute(0, 1, 3, 6, 4, 5, 2, 7)
    # vertex 8t + g, columns c 16 + kh 8 + q 2 + pair -> (g, q, c, kh, pair)
    vf = va.view(B, T, 8, KC, 2, 4, 2).permute(0, 1, 2, 5, 3, 4, 6)
    vidx = torch.nn.functional.pad(vorder.to(torch.int32), (0, T * 8 - V),
                                   value=NO_INDEX)
    pidx = torch.nn.functional.pad(porder.to(torch.int32), (0, Mt * 16 - N))
    mid = torch.clamp(torch.arange(-(-N // BLOCK_POINTS), device=P.device)
                      * BLOCK_POINTS + BLOCK_POINTS // 2, max=max(N - 1, 0))
    first = torch.clamp(torch.searchsorted(vcode, pcode[:, mid].contiguous())
                        // STAGE_VERTS, max=-(-T * 8 // STAGE_VERTS) - 1)
    return (pf.reshape(B, Mt, 32, 8 * KC).contiguous(),
            vf.reshape(B, T, 32, 4 * KC).contiguous(), vidx.contiguous(),
            pidx.contiguous(), first.to(torch.int32).contiguous())


def mxu_operands_cuda(points: torch.Tensor, verts: torch.Tensor,
                      precision: str):
    """``mxu_operands`` on the card, bit for bit: the centre and the box
    in torch, the Morton codes by one kernel (csrc/knn_mxu.cu
    mxu_codes_kernel), torch's stable sort, then one kernel
    (mxu_pack_kernel) that forms the rows as ``augmented_rows`` does and
    writes the fragments, the index maps and each block's first stage."""
    B, N, V = points.shape[0], points.shape[1], verts.shape[1]
    Mt, T = -(-N // 16), -(-V // 8)
    KC = DEPTH[precision] // 16
    dev = points.device
    points, verts = points.contiguous(), verts.contiguous()
    c = verts.mean(dim=1).contiguous()
    lo, hi = morton_box(points, verts)
    pcode = torch.empty((B, N), dtype=torch.int32, device=dev)
    vcode = torch.empty((B, V), dtype=torch.int32, device=dev)
    _build.check_cuda("knn_mxu", points, verts, c, lo, hi)
    lib = _build.kernel_library()
    stream = _build.stream_of(points)
    lib.call("animnerf_knn_mxu_codes", points.data_ptr(), verts.data_ptr(),
             lo.data_ptr(), hi.data_ptr(), pcode.data_ptr(),
             vcode.data_ptr(), B, N, V, stream)
    pcode, porder = pcode.sort(dim=1, stable=True)
    vcode, vorder = vcode.sort(dim=1, stable=True)
    pf = torch.empty((B, Mt, 32, 8 * KC), dtype=torch.bfloat16, device=dev)
    vf = torch.empty((B, T, 32, 4 * KC), dtype=torch.bfloat16, device=dev)
    vidx = torch.empty((B, T * 8), dtype=torch.int32, device=dev)
    pidx = torch.empty((B, Mt * 16), dtype=torch.int32, device=dev)
    first = torch.empty((B, -(-N // BLOCK_POINTS)), dtype=torch.int32,
                        device=dev)
    lib.call("animnerf_knn_mxu_pack", points.data_ptr(), verts.data_ptr(),
             c.data_ptr(), porder.data_ptr(), vorder.data_ptr(),
             pcode.data_ptr(), vcode.data_ptr(), pf.data_ptr(),
             vf.data_ptr(), pidx.data_ptr(), vidx.data_ptr(),
             first.data_ptr(), B, N, V, KC, stream)
    return pf, vf, vidx, pidx, first


def mxu_eps(points: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """(B, N) float64: the bound eps = EPS_SCALE (|p| + max |v|)^2 on how
    far the kernel's d2 may lie from the plain version's (this module's
    docstring derives it), on the centred coordinates."""
    c = verts.double().mean(dim=1, keepdim=True)
    rp = (points.double() - c).norm(dim=-1)
    rv = (verts.double() - c).norm(dim=-1).amax(dim=1, keepdim=True)
    return EPS_SCALE * (rp + rv) ** 2


def _check(points, verts, k, precision):
    if k != K:
        raise ValueError(f"knn_mxu computes the top-{K} only, got k={k}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    check_points_verts(points, verts, min_verts=K, max_verts=2**31 - 1)


def knn_mxu(points: torch.Tensor, verts: torch.Tensor, k: int = K,
            precision: str = "highest", stats: torch.Tensor = None):
    """Kernel on CUDA tensors, plain version on CPU tensors. ``stats``
    (CUDA, 3 int64, zeroed by the caller): the kernel adds its warps'
    steps that took the insert pass, the values inserted and the threshold
    refreshes."""
    _check(points, verts, k, precision)
    if points.device.type == "cpu":
        return knn_mxu_plain(points, verts, k, precision)
    B, N, _ = points.shape
    d = torch.empty((B, K, N), dtype=torch.float32, device=points.device)
    i = torch.empty((B, K, N), dtype=torch.int32, device=points.device)
    if N > 0:
        ops = mxu_operands_cuda(points.detach(), verts.detach(), precision)
        _build.kernel_library().call(
            "animnerf_knn_mxu", *(t.data_ptr() for t in ops), d.data_ptr(),
            i.data_ptr(), None if stats is None else stats.data_ptr(), B, N,
            verts.shape[1], DEPTH[precision] // 16,
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


# ---- a model of the kernel's selection, for tests

def refreshes_after(v: int) -> bool:
    """csrc/knn_mxu.cu: whether the lanes' thresholds drop to the 4th of
    their quad's union after the v-th vertex tile a block visits (from 0):
    v = 0, 1, 3, 7, ..., 63, then every 64th."""
    return (v & (v + 1)) == 0 or v % 64 == 63


def _lex_less(a, ia, b, ib):
    return (a < b) | ((a == b) & (ia < ib))


def _lex_merge(d, i, mask: int):
    """lex_merge of csrc/knn_mxu.cu on (c, 4 lanes, 4) lists: lane q with
    lane q ^ mask, a bitonic merge by (d2, index)."""
    q = np.arange(4) ^ mask
    e, ie = d[:, q, ::-1], i[:, q, ::-1]
    s = _lex_less(e, ie, d, i)
    d, i = np.where(s, e, d), np.where(s, ie, i)
    for a, b in ((0, 2), (1, 3), (0, 1), (2, 3)):
        s = _lex_less(d[..., b], i[..., b], d[..., a], i[..., a])
        da, ia = d[..., a].copy(), i[..., a].copy()
        d[..., a] = np.where(s, d[..., b], da)
        i[..., a] = np.where(s, i[..., b], ia)
        d[..., b] = np.where(s, da, d[..., b])
        i[..., b] = np.where(s, ia, i[..., b])
    return d, i


def _quad_fourth(d):
    """quad_fourth of csrc/knn_mxu.cu on (c, 4 lanes, 4) sorted values."""
    c = np.minimum(d, d[:, np.arange(4) ^ 1, ::-1])
    lo0, hi0 = np.minimum(c[..., 0], c[..., 2]), np.maximum(c[..., 0],
                                                            c[..., 2])
    lo1, hi1 = np.minimum(c[..., 1], c[..., 3]), np.maximum(c[..., 1],
                                                            c[..., 3])
    c = np.stack([np.minimum(lo0, lo1), np.maximum(lo0, lo1),
                  np.minimum(hi0, hi1), np.maximum(hi0, hi1)], axis=-1)
    return np.minimum(c, c[:, np.arange(4) ^ 2, ::-1]).max(axis=-1)


def _offer(d, i, thr, x, ix):
    """Each lane's value x (index ix) against its threshold and, if it
    passes, its list (csrc/knn_mxu.cu insert) on (c, 4 lanes) arrays."""
    hit = x <= thr
    ins = hit & _lex_less(x, ix, d[..., 3], i[..., 3])
    p = [_lex_less(x, ix, d[..., s], i[..., s]) for s in range(3)]
    nd, ni = d.copy(), i.copy()
    nd[..., 3] = np.where(p[2], d[..., 2], x)
    ni[..., 3] = np.where(p[2], i[..., 2], ix)
    nd[..., 2] = np.where(p[1], d[..., 1], np.where(p[2], x, d[..., 2]))
    ni[..., 2] = np.where(p[1], i[..., 1], np.where(p[2], ix, i[..., 2]))
    nd[..., 1] = np.where(p[0], d[..., 0], np.where(p[1], x, d[..., 1]))
    ni[..., 1] = np.where(p[0], i[..., 0], np.where(p[1], ix, i[..., 1]))
    nd[..., 0] = np.where(p[0], x, d[..., 0])
    ni[..., 0] = np.where(p[0], ix, i[..., 0])
    d = np.where(ins[..., None], nd, d)
    i = np.where(ins[..., None], ni, i)
    return d, i, np.where(hit, np.minimum(thr, d[..., 3]), thr)


def quad_select_model(d2: np.ndarray, index=None, first: int = 0):
    """The kernel's selection, step for step, on (c, V) float32 d2 as its
    accumulators hold them at the vertex positions (Morton order), index
    (V,) the positions' input indices (default: the positions), first the
    block's first stage -> (d2, idx) (c, 4), ascending by (d2, index). The
    block visits the stages of STAGE_VERTS from first round to the last
    and on from 0, two tiles a step; lane q of a point's quad meets
    positions 8t + 2q and 8t + 2q + 1 of each tile t (+inf past V), and a
    value at most its threshold goes into its list when below the list's
    4th by (d2, index) (``_offer``), the threshold dropping to the list's
    4th value, and after a step holding a visit of ``refreshes_after`` to
    the quad's 4th (``quad_fourth``); then two ``lex_merge`` rounds (lane
    ^ 1, lane ^ 2). Every lane ends with the same list."""
    c, V = d2.shape
    T = -(-V // 8)
    TV = STAGE_VERTS // 8
    S = -(-T // TV)
    x = np.full((c, T * 8), np.inf, np.float32)
    x[:, :V] = d2
    ind = np.full(T * 8, NO_INDEX, np.int64)
    ind[:V] = np.arange(V) if index is None else index
    d = np.full((c, 4, 4), np.inf, np.float32)
    i = np.full((c, 4, 4), NO_INDEX, np.int64)
    thr = np.full((c, 4), np.inf, np.float32)
    lanes = np.arange(4)
    steps = []  # (tiles, the step's first visit): two tiles a step
    for s in range(S):
        ss = (first + s) % S
        for t in range(ss * TV, min((ss + 1) * TV, T), 2):
            steps.append((range(t, min(t + 2, (ss + 1) * TV, T)),
                          2 * len(steps)))
    for step, visited in steps:
        for t in step:
            for j in range(2):
                v = 8 * t + 2 * lanes + j
                d, i, thr = _offer(d, i, thr, x[:, v],
                                   np.broadcast_to(ind[v], (c, 4)))
        if refreshes_after(visited) or refreshes_after(visited + 1):
            thr = np.minimum(thr, _quad_fourth(d))
    d, i = _lex_merge(d, i, 1)
    d, i = _lex_merge(d, i, 2)
    assert (d == d[:, :1]).all() and (i == i[:, :1]).all()
    return d[:, 0], i[:, 0]
