"""The port's kNN and nearest-vertex distance (plain versions) against the
TPU kernels in interpret mode, on the CPU: the packed tournament kernel
(``knn_pallas(packed=True)``), the exact kernel (``packed=False``), the
dispatch between them and ``min_dist_pallas``."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animnerf_tpu.ops.knn_pallas import knn_pallas
from animnerf_tpu_torch.ops.knn_kernel import knn_top4, knn_top4_plain

torch.set_num_threads(1)


def _cloud(V=1000, N=2048, seed=0):
    rng = np.random.default_rng(seed)
    verts = rng.normal(scale=0.3, size=(1, V, 3)).astype(np.float32)
    pts = (verts[:, rng.integers(0, V, N)]
           + rng.normal(scale=0.05, size=(1, N, 3))).astype(np.float32)
    return pts, verts


def test_knn_plain_matches_tournament_kernel():
    pts, verts = _cloud()
    dj, ij = knn_pallas(jnp.asarray(pts), jnp.asarray(verts), k=4,
                        packed=True, transposed_out=True, interpret=True)
    dj, ij = np.asarray(dj), np.asarray(ij)
    dt, it = knn_top4(torch.from_numpy(pts), torch.from_numpy(verts))
    dt, it = dt.numpy(), it.numpy()
    assert dt.shape == dj.shape == (1, 4, 2048) and it.dtype == np.int32
    # XLA:CPU contracts the dot form's multiply-adds into FMAs (the TPU
    # kernel and the port round every product), so a d2 within rounding
    # of a key-quantum edge (the 13 dropped mantissa bits: 2^-10 relative
    # on d2) can land in the neighbouring quantum. Indices agree except
    # where two candidates' d2 fall within one quantum; distances agree to
    # 1 ulp except on such edges, where they differ by one quantum.
    diff = ij != it
    if diff.any():
        p = pts[0][np.nonzero(diff)[2]].astype(np.float64)
        va = verts[0][ij[diff]].astype(np.float64)
        vb = verts[0][it[diff]].astype(np.float64)
        d2a = ((p - va) ** 2).sum(-1)
        d2b = ((p - vb) ** 2).sum(-1)
        assert np.all(np.abs(d2a - d2b) <= 2.0 ** -10 * np.maximum(d2a, d2b)
                      + 1e-6)
    assert diff.mean() < 1e-3
    same = ~diff
    edge = same & (np.abs(dt - dj) > 2 * np.spacing(dj))
    assert edge.mean() < 0.05
    np.testing.assert_array_max_ulp(dt[same & ~edge], dj[same & ~edge],
                                    maxulp=1)
    quantum_d = 2.0 ** -10 * np.maximum(dt, dj)  # one d2 quantum, on d
    assert np.all(np.abs(dt - dj)[edge] <= quantum_d[edge])


def test_knn_sorted_and_exact_on_distinct_points():
    pts, verts = _cloud(V=300, N=500, seed=1)
    d, i = knn_top4_plain(torch.from_numpy(pts), torch.from_numpy(verts),
                          max_elems=4096)  # several chunks
    d, i = d.numpy(), i.numpy()
    assert np.all(np.diff(d, axis=1) >= 0)
    ref = np.sqrt(((pts[0][:, None] - verts[0][None]) ** 2).sum(-1))
    want = np.sort(ref, axis=1)[:, :4].T
    # quantized d2: <= 2^-10 relative on d2 (~5e-4 relative on d) plus the
    # dot form's cancellation near zero
    np.testing.assert_allclose(d[0], want, rtol=1e-3, atol=1e-3)


def test_tile_skip_is_ignored_by_the_plain_version_and_boxes_bound_tiles():
    """On the CPU ``tile_skip`` takes the plain version (the kernel's output
    is bit-identical either way); the tile AABBs hold every vertex of
    their 1024-vertex tile."""
    from animnerf_tpu_torch.ops.knn_kernel import TILE_V, tile_boxes

    pts, verts = _cloud(V=2500, N=300, seed=2)
    tp, tv = torch.from_numpy(pts), torch.from_numpy(verts)
    a = knn_top4(tp, tv, tile_skip=True)
    b = knn_top4(tp, tv)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    box = tile_boxes(tv).numpy()
    nt = -(-2500 // TILE_V)
    assert box.shape == (1, nt, 8)
    for t in range(nt):
        v = verts[0, t * TILE_V:(t + 1) * TILE_V]
        np.testing.assert_array_equal(box[0, t, :3], v.min(0))
        np.testing.assert_array_equal(box[0, t, 3:6], v.max(0))


@pytest.mark.parametrize("stratified", [True, False])
@pytest.mark.parametrize("V", [4, 1025, 8192])
def test_vertex_rows_match_numpy_and_padding_never_enters(V, stratified):
    """The rows the packed kernels sweep (``vertex_rows``, on the CPU its
    plain version) against a numpy restatement, bit for bit: the visiting
    order (tiles interleaved or in index order, rows bit-reversed within a
    256-row tile), each row (-2v, |v|^2) rounded per operation, and the
    padding rows (0, 0, 0, +inf). Keys computed from those rows as the
    kernels do, padding included, give the plain top-k: a padded row never
    enters it."""
    from animnerf_tpu_torch.ops.knn_kernel import (
        TILE_V,
        knn_packed_plain,
        vertex_rows,
    )

    pts, verts = _cloud(V=V, N=259, seed=20)
    rows, order = vertex_rows(torch.from_numpy(verts), stratified)
    nt = -(-V // TILE_V)
    pos = np.arange(nt * TILE_V)
    t, j = (pos % nt, pos // nt) if stratified else (pos // TILE_V,
                                                       pos % TILE_V)
    rev = np.array([int(format(x, "08b")[::-1], 2) for x in j])
    want_order = (t * TILE_V + rev).astype(np.int32)
    np.testing.assert_array_equal(order.numpy(), want_order)
    assert np.array_equal(np.sort(want_order), pos)
    real = want_order < V
    vv = verts[0][want_order[real]]
    want = np.zeros((nt * TILE_V, 4), np.float32)
    want[~real, 3] = np.inf
    want[real, :3] = -(vv + vv)
    want[real, 3] = (vv[:, 0] * vv[:, 0] + vv[:, 1] * vv[:, 1]) \
        + vv[:, 2] * vv[:, 2]
    assert rows.shape == (1, nt * TILE_V, 4)
    np.testing.assert_array_equal(rows.numpy()[0].view(np.int32),
                                  want.view(np.int32))
    p = pts[0]
    pp = (p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]) + p[:, 2] * p[:, 2]
    s = want[None, :, 2] * p[:, 2:3] + (
        want[None, :, 1] * p[:, 1:2]
        + (want[None, :, 0] * p[:, 0:1] + want[None, :, 3]))
    d2 = np.maximum(pp[:, None] + s, np.float32(0))
    key = (d2.view(np.int32) & ~0x1FFF) | want_order[None]
    for k in sorted({1, 4, min(16, V)}):
        top = np.sort(key, axis=1)[:, :k]
        assert np.all(top & 0x1FFF < V)
        d, i = knn_packed_plain(torch.from_numpy(pts),
                                torch.from_numpy(verts), k)
        np.testing.assert_array_equal(i.numpy()[0], (top & 0x1FFF).T)
        want_d = np.sqrt((top & ~0x1FFF).view(np.float32).astype(np.float64))
        np.testing.assert_array_equal(d.numpy()[0],
                                      want_d.astype(np.float32).T)


def test_keep_rows_within_boxes_matches_jax():
    """The rows-form box pre-pass against the JAX package's: exact."""
    from animnerf_tpu.ops.knn import keep_rows_within_boxes as j_keep
    from animnerf_tpu_torch.ops.knn import keep_rows_within_boxes

    pts, verts = _cloud(V=1000, N=3000, seed=3)
    rows = np.zeros((1, 8, 3000), np.float32)
    rows[0, :3] = pts[0].T + np.random.default_rng(4).normal(
        scale=0.2, size=(3, 3000)).astype(np.float32)
    a = np.asarray(j_keep(jnp.asarray(rows), jnp.asarray(verts), 0.2))
    b = keep_rows_within_boxes(torch.from_numpy(rows),
                               torch.from_numpy(verts), 0.2).numpy()
    assert 0 < b.sum() < b.size
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------- exact kNN, min distance


def _smplx_cloud(N, seed):
    """Points around a V=10475 cloud (SMPL-X's vertex count)."""
    return _cloud(V=10475, N=N, seed=seed)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


def _knn_exact(pts, verts):
    from animnerf_tpu_torch.ops.knn_kernel import knn_exact

    d, i = knn_exact(torch.from_numpy(pts), torch.from_numpy(verts))
    return d.numpy(), i.numpy()


def _fma_free_d2(pts, verts):
    """numpy f32 ((vx-px)^2 + (vy-py)^2) + (vz-pz)^2, every op rounded."""
    e = verts[0][None] - pts[0][:, None]
    return (e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]) \
        + e[..., 2] * e[..., 2]


def test_knn_exact_plain_matches_exact_kernel():
    """knn_exact_plain against the TPU exact kernel (``packed=False``) in
    interpret mode at V=10475. XLA:CPU contracts the interpret-mode sum
    into fma(ez, ez, fma(ex, ex, ey*ey)), which saves two of the TPU
    kernel's roundings of d2, so distances agree within 2 ulps (1 ulp of
    d2 per contraction, halved by the sqrt, plus the sqrt's own rounding)
    and indices agree except where two candidates' d2 lie within that
    rounding of each other."""
    pts, verts = _smplx_cloud(1500, seed=5)
    dj, ij = knn_pallas(jnp.asarray(pts), jnp.asarray(verts), k=4,
                        packed=False, transposed_out=True, interpret=True)
    dj, ij = np.asarray(dj), np.asarray(ij)
    dt, it = _knn_exact(pts, verts)
    assert dt.shape == dj.shape == (1, 4, 1500) and it.dtype == np.int32
    diff = ij != it
    if diff.any():
        p = pts[0][np.nonzero(diff)[2]].astype(np.float64)
        d2a = ((p - verts[0][ij[diff]]) ** 2).sum(-1)
        d2b = ((p - verts[0][it[diff]]) ** 2).sum(-1)
        assert np.all(np.abs(d2a - d2b) <= 4 * np.spacing(
            np.maximum(d2a, d2b).astype(np.float32)))
    assert diff.mean() < 1e-3
    assert _ulps(dt[~diff], dj[~diff]).max() <= 2
    assert np.all(np.diff(dt, axis=1) >= 0)


def _tpu_slots_topk(d2, k, tile=512):
    """numpy/Python emulation of _knn_kernel's top-k rule for one point's
    d2 row (knn_pallas.py:89-155): per tile the k smallest (d2, index)
    pairs, each replacing the first slot holding the slots' maximum when
    strictly smaller; then the k=4 network or the bubble network, swapping
    on a strictly larger d2."""
    sd, si = [np.float32(np.inf)] * k, [0] * k
    for t0 in range(0, len(d2), tile):
        seg = d2[t0:t0 + tile]
        for j in np.argsort(seg, kind="stable")[:k]:
            m = max(sd)
            a = sd.index(m)
            if seg[j] < m:
                sd[a], si[a] = seg[j], t0 + int(j)
    net = ([(0, 1), (2, 3), (0, 2), (1, 3), (1, 2)] if k == 4 else
           [(a, a + 1) for end in range(k - 1, 0, -1) for a in range(end)])
    for a, b in net:
        if sd[a] > sd[b]:
            sd[a], sd[b], si[a], si[b] = sd[b], sd[a], si[b], si[a]
    return np.array(sd, np.float32), np.array(si)


@pytest.mark.parametrize("k", [4, 8])
def test_knn_exact_plain_rounds_like_the_tpu_kernel(k):
    """Bit for bit against numpy's separately rounded f32 sums and a
    Python emulation of the TPU kernel's slot rule (duplicated vertices
    tie exactly), over several chunks."""
    from animnerf_tpu_torch.ops.knn_kernel import knn_exact_plain

    pts, verts = _cloud(V=600, N=300, seed=6)
    verts[0, 400:410] = verts[0, 100:110]  # exact ties
    pts[0, :10] = verts[0, 100:110] + np.float32(1e-3)
    d, i = knn_exact_plain(torch.from_numpy(pts), torch.from_numpy(verts), k,
                           max_elems=6000)
    d2 = _fma_free_d2(pts, verts)
    want = [_tpu_slots_topk(row, k) for row in d2]
    np.testing.assert_array_equal(i.numpy()[0], np.stack([w[1] for w in want]).T)
    want_d = np.sqrt(np.stack([w[0] for w in want]).astype(np.float64))
    np.testing.assert_array_equal(d.numpy()[0], want_d.astype(np.float32).T)
    assert np.all(i.numpy()[0, 0, :10] < 400)
    assert np.all(np.diff(d.numpy(), axis=1) >= 0)


def _tie_cloud():
    """A point at the origin and V=600 vertices: v0 (1,0,0), v1 (0,1,1),
    v3 (1,2,0), v7 (2,1,0) and v520 (2,0,0), every other vertex at
    x >= 10. v3 and v7 tie exactly at d2 = 5."""
    verts = np.zeros((1, 600, 3), np.float32)
    verts[0, :, 0] = 10 + np.arange(600)
    for v, xyz in ((0, (1, 0, 0)), (1, (0, 1, 1)), (3, (1, 2, 0)),
                   (7, (2, 1, 0)), (520, (2, 0, 0))):
        verts[0, v] = xyz
    return np.zeros((1, 1, 3), np.float32), verts


@pytest.mark.parametrize("k", [4, 8])
def test_exact_knn_breaks_ties_as_the_tpu_kernel(k):
    """On the tie cloud the TPU kernel (tile_v=512) keeps v7 at k=4: v3
    and v7 enter tile 0's top-4 and v520 then evicts the first slot that
    holds the maximum, v3's. The port returns what knn_pallas(packed=False)
    returns, indices and distances."""
    from animnerf_tpu_torch.ops.knn_kernel import knn

    pts, verts = _tie_cloud()
    dj, ij = knn_pallas(jnp.asarray(pts), jnp.asarray(verts), k=k, tile_v=512,
                        packed=False, interpret=True, transposed_out=True)
    d, i = knn(torch.from_numpy(pts), torch.from_numpy(verts), k,
               packed=False)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(d.numpy(), np.asarray(dj))
    if k == 4:
        np.testing.assert_array_equal(i.numpy()[0, :, 0], [0, 1, 520, 7])


@pytest.mark.parametrize("V,packed,exact", [
    (8192, True, False), (8193, True, True), (8192, False, True)])
def test_knn_dispatches_by_vertex_count(V, packed, exact):
    """knn takes the packed kernel up to 8192 vertices and the exact one
    above (and with packed=False): the output is the one or the other
    version's, and the two differ (quantised vs exact distances)."""
    from animnerf_tpu_torch.ops.knn_kernel import knn, knn_exact_plain

    pts, verts = _cloud(V=V, N=200, seed=7)
    tp, tv = torch.from_numpy(pts), torch.from_numpy(verts)
    got = knn(tp, tv, tile_skip=True, packed=packed)
    want_exact = knn_exact_plain(tp, tv)
    if V <= 8192:
        want_packed = knn_top4_plain(tp, tv)
    else:
        with pytest.raises(ValueError, match="8192"):
            knn_top4_plain(tp, tv)
        want_packed = knn_top4_plain(tp, tv[:, :8192].contiguous())
    assert not torch.equal(want_exact[0], want_packed[0])
    want = want_exact if exact else want_packed
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_min_vertex_distance_plain_matches_kernel():
    """min_vertex_distance_plain against the TPU min-distance kernel in
    interpret mode at V=10475: within 2 ulps (XLA:CPU's two FMA
    contractions, as for the exact kNN); bit-equal to the exact kNN's
    nearest distance and to numpy's separately rounded sums."""
    from animnerf_tpu.ops.knn_pallas import min_dist_pallas
    from animnerf_tpu_torch.ops.knn import (
        min_vertex_distance,
        min_vertex_distance_plain,
    )
    from animnerf_tpu_torch.ops.knn_kernel import knn_exact_plain

    pts, verts = _smplx_cloud(1200, seed=8)
    mj = np.asarray(min_dist_pallas(jnp.asarray(pts), jnp.asarray(verts),
                                    interpret=True))
    tp, tv = torch.from_numpy(pts), torch.from_numpy(verts)
    mt = min_vertex_distance(tp, tv).numpy()
    assert mt.shape == mj.shape == (1, 1200)
    assert _ulps(mt, mj).max() <= 2
    np.testing.assert_array_equal(mt, knn_exact_plain(tp, tv)[0][:, 0])
    d2 = _fma_free_d2(pts, verts).min(1).astype(np.float64)
    np.testing.assert_array_equal(mt[0], np.sqrt(d2).astype(np.float32))
    again = min_vertex_distance_plain(tp, tv, max_elems=50000).numpy()
    np.testing.assert_array_equal(again, mt)
