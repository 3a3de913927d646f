"""The matmul-form kNN's tensor-core operands and selection (kernel 10,
``ops/knn_mxu.py``): the bf16 fragments ``mxu_operands`` packs, decoded
by the mma.m16n8k16 fragment tables, against the plain version's rows;
their exact products against the plain version's (equal at "default",
within the split's bound at "highest", on the kNN tool's clouds and 300 m
from the origin); the bound eps the card is held to, against the plain
version's own rounding; and the numpy model of the kernel's quad split,
thresholds and lexicographic merge against a full (d2, index) top-4."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from animnerf_tpu_torch.ops.knn_mxu import (
    BLOCK_POINTS,
    DEPTH,
    EPS_SCALE,
    LIVE,
    NO_INDEX,
    STAGE_VERTS,
    augmented_rows,
    mxu_d2,
    mxu_eps,
    mxu_operands,
    quad_select_model,
    refreshes_after,
)
from animnerf_tpu_torch.tools.bench_knn import make_inputs

U = 2.0 ** -24


def _decode(ops, N: int, V: int):
    """The (B, N, D) point and (B, V, D) vertex operands the fragments of
    ``mxu_operands`` hold, in input order: decoded by the PTX ISA's
    tables for mma.m16n8k16 .bf16 (A (row) a0 a1 row g, columns 2q + (0,
    1); a2 a3 row g + 8; a4 a5 row g, + 8 columns; a6 a7 row g + 8, + 8
    columns; B (col) b0 b1 rows 2q + (0, 1) of column g, b2 b3 + 8 rows;
    g = lane >> 2, q = lane & 3), then put back by pidx and vidx, which
    must be permutations (NO_INDEX past V)."""
    pf, vf, vidx, pidx, first = ops
    pf, vf = pf.float().numpy(), vf.float().numpy()
    vidx, pidx = vidx.numpy(), pidx.numpy()
    B, Mt, _, W = pf.shape
    KC = W // 8
    D = 16 * KC
    T = vf.shape[1]
    P = np.full((B, Mt * 16, D), np.nan, np.float32)
    A = np.full((B, T * 8, D), np.nan, np.float32)
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        for c in range(KC):
            for r in range(4):
                for e in range(2):
                    row = g + 8 * (r & 1)
                    col = 16 * c + 2 * q + e + 8 * (r >> 1)
                    P[:, row::16, col] = pf[:, :, lane, 8 * c + 2 * r + e]
            for r in range(2):
                for e in range(2):
                    col = 16 * c + 2 * q + e + 8 * r
                    A[:, g::8, col] = vf[:, :, lane, 4 * c + 2 * r + e]
    assert not np.isnan(P).any() and not np.isnan(A).any()
    assert (P[:, N:] == 0).all() and (A[:, V:] == 0).all()
    assert (vidx[:, V:] == NO_INDEX).all()
    S = -(-T * 8 // STAGE_VERTS)
    assert first.shape == (B, -(-Mt * 16 // BLOCK_POINTS))
    assert ((first >= 0) & (first < S)).all()
    Pi = np.empty((B, N, D))
    Ai = np.empty((B, V, D))
    for b in range(B):
        assert sorted(pidx[b, :N]) == list(range(N))
        assert sorted(vidx[b, :V]) == list(range(V))
        Pi[b, pidx[b, :N]] = P[b, :N]
        Ai[b, vidx[b, :V]] = A[b, :V]
    return Pi, Ai


def _clouds():
    """The kNN tool's vertices and first point set at a small size, and
    the same 300 m from the origin (centred on the vertices' mean before
    the rows are built, as the tool does)."""
    verts, sets = make_inputs(2, 200, V=700)
    shift = np.float32([300.0, -120.0, 40.0])
    return [(torch.from_numpy(sets[0]), torch.from_numpy(verts)),
            (torch.from_numpy(sets[1] + shift),
             torch.from_numpy(verts + shift))]


@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("N,V", [(200, 700), (37, 13), (16, 8)])
def test_fragments_hold_the_plain_rows(precision, N, V):
    """Decoded by the fragment tables, the operands are the augmented
    rows' 5 live columns: bf16-rounded at "default" (the rows
    knn_mxu_plain("default") multiplies); at "highest" the hi / mid / lo
    parts in the six cross products' order, whose three parts sum to the
    f32 value within 2^-24 of it; zero-padded rows and columns."""
    rng = np.random.default_rng(N + V)
    pts = torch.from_numpy(rng.normal(size=(2, N, 3)).astype(np.float32))
    verts = torch.from_numpy(rng.normal(scale=0.3, size=(2, V, 3))
                             .astype(np.float32))
    ops = mxu_operands(pts, verts, precision)
    assert ops[0].dtype == ops[1].dtype == torch.bfloat16
    assert all(t.dtype == torch.int32 for t in ops[2:])
    P, A = _decode(ops, N, V)
    Pr, Ar = augmented_rows(pts, verts)
    p5 = Pr[:, :5].transpose(1, 2).numpy().astype(np.float64)
    v5 = Ar[..., :5].numpy().astype(np.float64)
    if precision == "default":
        assert P.shape[-1] == A.shape[-1] == DEPTH["default"]
        want_p = Pr[:, :5].transpose(1, 2).to(torch.bfloat16).double()
        want_v = Ar[..., :5].to(torch.bfloat16).double()
        np.testing.assert_array_equal(P[..., :5], want_p.numpy())
        np.testing.assert_array_equal(A[..., :5], want_v.numpy())
        live = LIVE["default"]  # the bound's products a pair
        assert (P[..., live:] == 0).all() and (A[..., live:] == 0).all()
        return
    assert P.shape[-1] == A.shape[-1] == DEPTH["highest"]
    ph, pm, pl = (P[..., 5 * j:5 * j + 5] for j in (0, 2, 5))
    vh, vm, vl = (A[..., 5 * j:5 * j + 5] for j in (0, 1, 3))
    for j, (a, b) in enumerate(((ph, vh), (ph, vm), (pm, vh), (ph, vl),
                                (pm, vm), (pl, vh))):
        np.testing.assert_array_equal(P[..., 5 * j:5 * j + 5], a)
        np.testing.assert_array_equal(A[..., 5 * j:5 * j + 5], b)
    live = LIVE["highest"]
    assert (P[..., live:] == 0).all() and (A[..., live:] == 0).all()
    for parts, want in (((ph, pm, pl), p5), ((vh, vm, vl), v5)):
        total = parts[0] + parts[1] + parts[2]
        assert (np.abs(total - want) <= U * np.abs(want)).all()
        assert (np.abs(parts[1]) <= 2.0 ** -8 * np.abs(want)).all()


@pytest.mark.parametrize("cloud", [0, 1])
def test_default_products_equal_the_plain_products(cloud):
    """"default": the packed columns' exact products, summed in float64,
    equal the exact products of the bf16-rounded rows that
    knn_mxu_plain("default") sums (only their rounding differs)."""
    pts, verts = _clouds()[cloud]
    P, A = _decode(mxu_operands(pts, verts, "default"), pts.shape[1],
                   verts.shape[1])
    Pr, Ar = augmented_rows(pts, verts)
    Pb = Pr.to(torch.bfloat16).double().numpy()       # (B, 8, N)
    Ab = Ar.to(torch.bfloat16).double().numpy()       # (B, V, 8)
    got = np.einsum("bnd,bvd->bnv", P, A)
    want = np.einsum("bcn,bvc->bnv", Pb, Ab)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cloud", [0, 1])
def test_highest_products_within_the_split_bound(cloud):
    """"highest": the six cross products of the 3-way split, summed in
    float64, lie within 4u S of the float64 product of the f32 rows (S =
    sum of |products|): what the split drops (mid.lo, lo.mid, lo.lo, its
    remainder) is at most u |x y| each. Also on the cloud 300 m out."""
    pts, verts = _clouds()[cloud]
    P, A = _decode(mxu_operands(pts, verts, "highest"), pts.shape[1],
                   verts.shape[1])
    Pr, Ar = augmented_rows(pts, verts)
    Pf, Af = Pr.double().numpy(), Ar.double().numpy()
    got = np.einsum("bnd,bvd->bnv", P, A)
    want = np.einsum("bcn,bvc->bnv", Pf, Af)
    S = np.einsum("bcn,bvc->bnv", np.abs(Pf), np.abs(Af))
    err = np.abs(got - want)
    assert (err <= 4 * U * S).all(), float((err / S).max() / U)
    assert err.max() > 0  # the split does drop something


@pytest.mark.parametrize("cloud", [0, 1])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_eps_covers_the_plain_rounding_and_the_split(cloud, precision):
    """eps = 2^-19 (|p| + max |v|)^2 bounds S, and the plain version's d2
    (mxu_d2: 8 products left to right, each rounded) lies within 8u S of
    the exact product of its rows, the packed operands' exact product
    within 4u S more at "highest": 12u S of eps's 32u, the rest left to
    the tensor core's two truncations a depth-16 product."""
    pts, verts = _clouds()[cloud]
    B, N, V = pts.shape[0], pts.shape[1], verts.shape[1]
    Pr, Ar = augmented_rows(pts, verts)
    if precision == "default":
        Pr = Pr.to(torch.bfloat16).float()
        Ar = Ar.to(torch.bfloat16).float()
    plain = mxu_d2(Pr, Ar).double().numpy()               # (B, N, V)
    P, A = _decode(mxu_operands(pts, verts, precision), N, V)
    packed = np.einsum("bnd,bvd->bnv", P, A)
    Pf, Af = Pr.double().numpy(), Ar.double().numpy()
    S = np.einsum("bcn,bvc->bnv", np.abs(Pf), np.abs(Af))
    eps = mxu_eps(pts, verts).numpy()[..., None]           # (B, N, 1)
    assert (S <= eps / (32 * U) * (1 + 2.0 ** -6)).all()
    assert (np.abs(plain - packed) <= 12 * U * S).all()
    assert EPS_SCALE == 32 * U


def _lex_top4(d2):
    idx = np.argsort(d2, axis=1, kind="stable")[:, :4]
    return np.take_along_axis(d2, idx, axis=1), idx


@pytest.mark.parametrize("V", [4, 5, 8, 13, 300, 1030])
@pytest.mark.parametrize("kind", ["tie_grid", "continuous", "descending"])
def test_selection_model_is_the_lexicographic_top4(V, kind):
    """The kernel's selection (a quad of lanes a point, each with its own
    list and threshold, the quad's 4th after the refresh visits, the
    stages from the block's first round, two lexicographic bitonic
    merges) gives the full (d2, index) top-4 whatever the positions'
    order and the first stage: on a tie grid (d2 on 6 values, 1/64
    apart), on continuous values, and on values falling along the visit
    (every tile inserts)."""
    rng = np.random.default_rng(V)
    c = 300
    if kind == "tie_grid":
        d2 = rng.integers(0, 6, (c, V)).astype(np.float32) / 64
    elif kind == "continuous":
        d2 = rng.random((c, V)).astype(np.float32)
    else:
        d2 = (np.arange(V, 0, -1)[None] + rng.integers(0, 2, (c, V))
              ).astype(np.float32)
    S = -(-V // STAGE_VERTS)
    for index, first in ((None, 0), (rng.permutation(V), S - 1),
                         (rng.permutation(V), S // 2)):
        d, i = quad_select_model(d2, index, first)
        ind = np.arange(V) if index is None else index
        order = np.lexsort((np.broadcast_to(ind, d2.shape), d2), axis=1)[:, :4]
        np.testing.assert_array_equal(i, ind[order])
        np.testing.assert_array_equal(d, np.take_along_axis(d2, order, 1))


def test_refresh_visits():
    """Thresholds drop to the quad's 4th after the 0th, 1st, 3rd, 7th,
    ..., 63rd tile a block visits, then after every 64th."""
    got = [t for t in range(300) if refreshes_after(t)]
    assert got == [0, 1, 3, 7, 15, 31, 63, 127, 191, 255]


def test_blocks_start_at_the_stage_of_their_points():
    """Morton order: a block's points lie together, and its first stage
    holds the vertex position where its middle point's code falls; on
    the tool's clouds the block's nearest vertices are mostly in it."""
    verts, sets = make_inputs(1, 4096)
    pts, vt = torch.from_numpy(sets[0]), torch.from_numpy(verts)
    pf, vf, vidx, pidx, first = mxu_operands(pts, vt, "default")
    p = pts[0][pidx[0].long()]
    v = vt[0][vidx[0, :vt.shape[1]].long()]
    near = torch.cdist(p, v).argmin(dim=1)              # sorted positions
    blk = torch.arange(p.shape[0]) // BLOCK_POINTS
    share = float((near // STAGE_VERTS == first[0, blk].long())
                  .float().mean())
    assert share > 0.3, share
