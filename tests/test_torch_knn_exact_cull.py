"""The exact kNN's cull (kernel 9, ``csrc/knn_exact.cu``) on the CPU: the
plain version the card holds the kernel against, bit for bit against the
TPU kernel with its cull (``knn_pallas(packed=False, cull=True)``) in
interpret mode; the kernel's vertex rows and boxes; and the two properties
the cull's exactness rests on, checked with numpy: the rounded box bound
never exceeds a rounded d2 in its box, and skipping what the current-slot
rule skips leaves the TPU top-k rule's output unchanged, ties included,
where a bound from elsewhere does not."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animnerf_tpu.ops.knn_pallas import knn_pallas
from animnerf_tpu_torch.ops import knn_kernel
from animnerf_tpu_torch.ops.knn_kernel import (
    SLOT_TILE,
    SUB_TILE,
    exact_d2,
    exact_rows,
    exact_rows_plain,
    knn,
    knn_exact,
    knn_exact_plain,
    tile_slots_topk,
)

torch.set_num_threads(1)


def _grid_cloud(V, N, seed):
    """Vertices and points on a 1/64 grid (|x| <= 0.875): every difference,
    square and sum of d2 is exact in f32, so XLA:CPU's FMA contraction
    changes no rounding, and d2 takes few values: many exact ties."""
    rng = np.random.default_rng(seed)
    verts = (rng.integers(-48, 49, size=(1, V, 3)) / 64).astype(np.float32)
    pts = (rng.integers(-56, 57, size=(1, N, 3)) / 64).astype(np.float32)
    return pts, verts


def _ray_cloud(seed=9):
    """tests/test_knn_warp.py's cull case: vertices (2, 900, 3) and
    ray-like coherent points, consecutive samples along 8 rays a batch,
    some far from the cloud."""
    rng = np.random.default_rng(seed)
    verts = rng.normal(scale=0.3, size=(2, 900, 3)).astype(np.float32)
    o = rng.normal(scale=2.0, size=(2, 8, 1, 3)).astype(np.float32)
    d = rng.normal(size=(2, 8, 1, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.linspace(0, 3, 48, dtype=np.float32).reshape(1, 1, 48, 1)
    return (o + t * d).reshape(2, -1, 3).astype(np.float32), verts


def _random_cloud(seed=9):
    """That test's random points, (2, 384, 3), against the same cloud."""
    rng = np.random.default_rng(seed)
    verts = rng.normal(scale=0.3, size=(2, 900, 3)).astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    return rng.normal(size=(2, 384, 3)).astype(np.float32), verts


def _tie_cloud():
    """tests/test_torch_knn.py's tie cloud: a point at the origin and 600
    vertices; v3 and v7 tie exactly at d2 = 5 and v520 evicts v3's slot."""
    verts = np.zeros((1, 600, 3), np.float32)
    verts[0, :, 0] = 10 + np.arange(600)
    for v, xyz in ((0, (1, 0, 0)), (1, (0, 1, 1)), (3, (1, 2, 0)),
                   (7, (2, 1, 0)), (520, (2, 0, 0))):
        verts[0, v] = xyz
    return np.zeros((1, 1, 3), np.float32), verts


def _culled_tpu(pts, verts, k):
    dj, ij = knn_pallas(jnp.asarray(pts), jnp.asarray(verts), k=k,
                        tile_v=SLOT_TILE, packed=False, cull=True,
                        interpret=True, transposed_out=True)
    return np.asarray(dj), np.asarray(ij)


def _port(pts, verts, k, **kw):
    d, i = knn_exact_plain(torch.from_numpy(pts), torch.from_numpy(verts), k,
                           **kw)
    return d.numpy(), i.numpy()


@pytest.mark.parametrize("V", ["k", 513, 1025])
@pytest.mark.parametrize("k", [1, 4, 8, 16])
def test_plain_is_culled_tpu_kernel_bit_for_bit_on_the_grid(k, V):
    """knn_exact_plain (and knn_exact on CPU tensors, either cull) against
    _knn_kernel with its cull at tile_v 512, on the 1/64 grid: V = k (one
    padded tile), 513 (one real vertex in the last tile), 1025; N = 259.
    Distances and indices bit for bit, ties included."""
    V = k if V == "k" else V
    pts, verts = _grid_cloud(V, 259, seed=40 + k)
    dj, ij = _culled_tpu(pts, verts, k)
    d, i = _port(pts, verts, k, max_elems=50000)  # several chunks
    assert d.shape == (1, k, 259)
    np.testing.assert_array_equal(i, ij)
    np.testing.assert_array_equal(d, dj)
    tp, tv = torch.from_numpy(pts), torch.from_numpy(verts)
    for cull in (True, False):
        dc, ic = knn_exact(tp, tv, k, cull=cull)
        assert np.array_equal(dc.numpy(), d) and np.array_equal(ic.numpy(), i)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("cloud", ["rays", "random"])
def test_plain_matches_culled_tpu_kernel_on_rays_and_random_points(cloud,
                                                                   k):
    """The coherent ray samples (most tiles culled) and random points (few)
    of tests/test_knn_warp.py's cull test against the culled TPU kernel,
    two batches. XLA:CPU contracts the interpret-mode d2 sum into FMAs
    (tests/test_torch_knn.py), so distances agree within 2 ulps and indices
    except where two candidates' d2 lie within that rounding."""
    pts, verts = _ray_cloud() if cloud == "rays" else _random_cloud()
    dj, ij = _culled_tpu(pts, verts, k)
    d, i = _port(pts, verts, k)
    assert d.shape == dj.shape == (2, k, pts.shape[1])
    diff = ij != i
    if diff.any():
        b, _, n = np.nonzero(diff)
        p = pts[b, n].astype(np.float64)
        d2a = ((p - verts[b, ij[diff]].astype(np.float64)) ** 2).sum(-1)
        d2b = ((p - verts[b, i[diff]].astype(np.float64)) ** 2).sum(-1)
        assert np.all(np.abs(d2a - d2b) <= 4 * np.spacing(
            np.maximum(d2a, d2b).astype(np.float32)))
    assert diff.mean() < 1e-2
    assert _ulps(d[~diff], dj[~diff]).max() <= 2
    assert np.all(np.diff(d, axis=1) >= 0)


@pytest.mark.parametrize("k", [4, 8])
def test_tie_cloud_under_the_cull(k):
    """On the tie cloud the culled TPU kernel keeps what the unculled one
    keeps (v7 at k=4, after v520 evicts v3's slot), and so does the port,
    bit for bit."""
    pts, verts = _tie_cloud()
    dj, ij = _culled_tpu(pts, verts, k)
    d, i = _port(pts, verts, k)
    np.testing.assert_array_equal(i, ij)
    np.testing.assert_array_equal(d, dj)
    if k == 4:
        np.testing.assert_array_equal(i[0, :, 0], [0, 1, 520, 7])


@pytest.mark.parametrize("V", [1, 64, 513, 1100])
def test_exact_rows_plain_layout(V):
    """The rows and boxes the kernel sweeps (``exact_rows``, on the CPU its
    plain version) against numpy: rows (x, y, z, 0) padded to whole
    512-vertex tiles with (+inf, +inf, +inf, 0); per 64-vertex sub-tile and
    per tile [min xyz, max xyz, 0, 0] over its real vertices, (+inf, -inf)
    where it has none."""
    rng = np.random.default_rng(V)
    verts = rng.normal(size=(2, V, 3)).astype(np.float32)
    rows, sbox, tbox = (t.numpy() for t in exact_rows(torch.from_numpy(verts)))
    Vp = -(-V // SLOT_TILE) * SLOT_TILE
    assert rows.shape == (2, Vp, 4) and rows.dtype == np.float32
    np.testing.assert_array_equal(rows[:, :V, :3], verts)
    assert np.all(rows[:, V:, :3] == np.inf) and np.all(rows[..., 3] == 0)
    for box, n in ((sbox, SUB_TILE), (tbox, SLOT_TILE)):
        assert box.shape == (2, Vp // n, 8)
        for t in range(Vp // n):
            v = verts[:, t * n:(t + 1) * n]
            if v.shape[1]:
                np.testing.assert_array_equal(box[:, t, :3], v.min(1))
                np.testing.assert_array_equal(box[:, t, 3:6], v.max(1))
            else:
                assert np.all(box[:, t, :3] == np.inf)
                assert np.all(box[:, t, 3:6] == -np.inf)
        assert np.all(box[..., 6:] == 0)
    for a, b in zip(exact_rows_plain(torch.from_numpy(verts)),
                    (rows, sbox, tbox)):
        assert np.array_equal(a.numpy(), b)


def _rounded_lb2(p, box):
    """numpy restatement of knn_exact.cu's rounded_lb2 for points (n, 3)
    and one box [lo xyz, hi xyz, ...]: per axis the gap
    max(max(lo - p, p - hi), 0), then ((gx^2 + gy^2) + gz^2), every f32
    operation rounded on its own (numpy does not contract)."""
    lo, hi = box[:3].astype(np.float32), box[3:6].astype(np.float32)
    g = np.maximum(np.maximum(lo - p, p - hi), np.float32(0))
    return (g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1]) + g[:, 2] * g[:, 2]


def _d2(p, v):
    """numpy f32 ((vx-px)^2 + (vy-py)^2) + (vz-pz)^2, every op rounded:
    (n, m)."""
    e = v[None] - p[:, None]
    return (e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]) \
        + e[..., 2] * e[..., 2]


@pytest.mark.parametrize("cloud", ["normal", "grid", "offset"])
def test_rounded_lb2_never_exceeds_a_rounded_d2_in_its_box(cloud):
    """A seeded sweep: for every 64-vertex box of ``exact_rows`` and
    points outside, on the faces of and inside it, lb2 <= the rounded d2
    of every vertex in the box (0 inside). Clouds: normal at 0.3 m, the
    1/64 grid (exact, tied values), and 0.1 m offsets around 100 m (large
    coordinates, cancellation in every difference)."""
    rng = np.random.default_rng({"normal": 1, "grid": 2, "offset": 3}[cloud])
    if cloud == "grid":
        pts, verts = _grid_cloud(1100, 400, seed=5)
        pts, verts = pts[0], verts[0]
    else:
        c, s = (0.0, 0.3) if cloud == "normal" else (100.0, 0.1)
        verts = (c + s * rng.normal(size=(1100, 3))).astype(np.float32)
        pts = (c + 1.5 * s * rng.normal(size=(400, 3))).astype(np.float32)
    _, sbox, _ = exact_rows(torch.from_numpy(verts[None]))
    sbox = sbox.numpy()[0]
    checked = 0
    for t in range(-(-len(verts) // SUB_TILE)):
        v = verts[t * SUB_TILE:(t + 1) * SUB_TILE]
        box = sbox[t]
        # points on the box's faces and corners, and inside it
        face = np.stack([box[0:3], box[3:6],
                         np.where(rng.random(3) < 0.5, box[0:3], box[3:6]),
                         v[0], v.mean(0).astype(np.float32)])
        p = np.concatenate([pts, face.astype(np.float32)])
        lb2 = _rounded_lb2(p, box)
        d2 = _d2(p, v)
        assert np.all(lb2[:, None] <= d2)
        inside = np.all((p >= box[:3]) & (p <= box[3:6]), axis=1)
        assert np.all(lb2[inside] == 0)
        checked += d2.size
    assert checked > 400 * 1100


def _sweep_skips(d2, lb2_tile, lb2_sub, k):
    """The kernel's skip decisions for one point, taken on the full
    sweep's state (which the skips leave unchanged if they are exact):
    per 512-vertex tile in index order, skipped when its lb2 exceeds the
    slots' maximum at its start; inside a swept tile, a 64-vertex sub-tile
    skipped when its lb2 exceeds the tile list's k-th entry at its start
    (the list starts full of the slots' maximum and takes, in index order,
    each d2 strictly below its k-th entry, an equal d2 after those there).
    Returns the (V,) bool mask of skipped vertices and whether a skipped
    vertex would have entered the list."""
    V = len(d2)
    skip = np.zeros(V, bool)
    sd, si = [np.float32(np.inf)] * k, [0] * k
    entered = False
    for t0 in range(0, V, SLOT_TILE):
        t = t0 // SLOT_TILE
        smax = max(sd)
        tile_skip = lb2_tile[t] > smax
        td = [(smax, 0)] * k
        for s0 in range(t0, min(t0 + SLOT_TILE, V), SUB_TILE):
            sub_skip = tile_skip or lb2_sub[s0 // SUB_TILE] > td[-1][0]
            for j in range(s0, min(s0 + SUB_TILE, V)):
                if d2[j] < td[-1][0]:
                    entered |= sub_skip
                    td = sorted(td[:-1] + [(d2[j], j)],
                                key=lambda e: e[0])  # stable: equal after
            if sub_skip:
                skip[s0:s0 + SUB_TILE] = True
        for x, j in td:  # ascending: each replaces the first maximum
            m = max(sd)
            if not x < m:
                break
            a = sd.index(m)
            sd[a], si[a] = x, j
    return skip, entered


def _morton_sorted(verts):
    """(1, V, 3) vertices in Morton order, as the warp hands them to the
    kNN (models/warp.py): the tiles are then spatially tight."""
    from animnerf_tpu_torch.ops.warp_blend import morton_codes

    order = np.argsort(morton_codes(torch.from_numpy(verts)).numpy()[0],
                       kind="stable")
    return np.ascontiguousarray(verts[:, order])


def _masked_topk(d2, mask, k):
    """tile_slots_topk (the plain version's rule) on (c, V) d2 with the
    masked vertices at +inf: (d2, idx) numpy."""
    d = torch.from_numpy(np.where(mask, np.float32(np.inf), d2))[None]
    sd, si = tile_slots_topk(d, k)
    return sd.numpy()[0], si.numpy()[0]


@pytest.mark.parametrize("group", [1, 32])
@pytest.mark.parametrize("cloud", ["rays", "random", "grid"])
def test_current_maximum_skips_leave_the_top_k_rule_unchanged(cloud, group):
    """The cull's exactness: masking out the tiles and sub-tiles that the
    current-maximum rule skips (per point, or per group of 32 consecutive
    points, as a warp skips only what all its points skip; the ray samples
    in ray order, the others in Morton order) leaves tile_slots_topk
    bit-identical, distances and indices; no skipped vertex would have
    entered a tile list. k = 4 and 8 over 1,300 Morton-sorted vertices
    (three tiles); k = 33, 40 and 64, the wide kernel's per-point cull
    (group 1), over 4,100 (nine tiles)."""
    for ks, extra in (((4, 8), 0), ((33, 40, 64), 2800)):
        _check_current_maximum_skips(cloud, group, ks, extra)


def _check_current_maximum_skips(cloud, group, ks, extra):
    if cloud == "grid":
        pts, verts = _grid_cloud(1300 + extra, 64, seed=8)
    else:
        pts, verts = _ray_cloud(4) if cloud == "rays" else _random_cloud(4)
        rng = np.random.default_rng(4)
        verts = np.concatenate(
            [verts[:1], rng.normal(scale=0.3, size=(1, 400 + extra, 3))],
            axis=1).astype(np.float32)
        pts = pts[:1, :64]
    verts = _morton_sorted(verts)
    if cloud != "rays":  # a warp's points: Morton runs, as in training
        pts = _morton_sorted(pts)
    p, v = pts[0], verts[0]
    d2 = _d2(p, v)
    np.testing.assert_array_equal(
        d2, exact_d2(torch.from_numpy(pts), torch.from_numpy(verts))[0])
    _, sbox, tbox = (b.numpy()[0] for b in exact_rows(torch.from_numpy(verts)))
    lb2_tile = np.stack([_rounded_lb2(p, b) for b in tbox], 1)
    lb2_sub = np.stack([_rounded_lb2(p, b) for b in sbox], 1)
    for k in ks:
        masks = []
        for n in range(len(p)):
            skip, entered = _sweep_skips(d2[n], lb2_tile[n], lb2_sub[n], k)
            assert not entered
            masks.append(skip)
        masks = np.stack(masks)
        for g in range(0, len(p), group):  # a group skips what all skip
            masks[g:g + group] = masks[g:g + group].all(0)
        assert masks.any(), "nothing skipped: the case tests nothing"
        want = _masked_topk(d2, np.zeros_like(masks), k)
        got = _masked_topk(d2, masks, k)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])


def test_a_bound_from_elsewhere_moves_tied_neighbours():
    """Why the cull never skips against a bound from outside the slot
    history (here the final k-th d2). k = 2, a point at the origin and
    three 512-vertex tiles, fillers at d2 = 100: tile 0 holds c at d2 = 5,
    tile 1 a at d2 = 1, tile 2 b at d2 = 1. In index order c enters a
    slot, a takes the other (the filler's), b evicts c: after the network
    the output is [b, a], which the TPU kernel with its cull, the plain
    version and the current-maximum rule (it skips nothing) agree on.
    Tile 0's box lies 2 m out (lb2 4), above the final k-th d2 (1):
    skipping it against that bound gives [a, b]."""
    verts = np.zeros((1, 3 * SLOT_TILE, 3), np.float32)
    verts[0, :SLOT_TILE] = (10, 0, 0)
    verts[0, SLOT_TILE:2 * SLOT_TILE] = (0, 10, 0)
    verts[0, 2 * SLOT_TILE:] = (0, 0, 10)
    c, a, b = 5, SLOT_TILE + 7, 2 * SLOT_TILE + 3
    verts[0, c], verts[0, a], verts[0, b] = (2, 1, 0), (1, 0, 0), (0, 1, 0)
    pts = np.zeros((1, 1, 3), np.float32)
    d2 = _d2(pts[0], verts[0])
    assert d2[0, [c, a, b]].tolist() == [5, 1, 1]

    dj, ij = _culled_tpu(pts, verts, 2)
    d, i = _port(pts, verts, 2)
    np.testing.assert_array_equal(ij[0, :, 0], [b, a])
    np.testing.assert_array_equal(i, ij)
    np.testing.assert_array_equal(d, dj)

    _, sbox, tbox = (t.numpy()[0] for t in exact_rows(torch.from_numpy(verts)))
    lb2_tile = np.stack([_rounded_lb2(pts[0], bx) for bx in tbox], 1)
    lb2_sub = np.stack([_rounded_lb2(pts[0], bx) for bx in sbox], 1)
    skip, _ = _sweep_skips(d2[0], lb2_tile[0], lb2_sub[0], 2)
    assert not skip[:SLOT_TILE].any()  # the slots are empty at tile 0
    assert _masked_topk(d2, skip[None], 2)[1].tolist() == [[b, a]]

    final_kth = np.sort(d2[0])[1]
    assert lb2_tile[0, 0] == 4 and lb2_tile[0, 0] > final_kth
    elsewhere = np.zeros_like(skip)
    elsewhere[:SLOT_TILE] = True
    assert _masked_topk(d2, elsewhere[None], 2)[1].tolist() == [[a, b]]


@pytest.mark.parametrize("V,packed", [(8193, True), (600, False)])
def test_knn_reaches_the_exact_kernel_with_its_cull(monkeypatch, V, packed):
    """``knn`` takes the exact kernel above 8192 vertices (or with
    packed=False) and asks for its cull, at every k."""
    calls = []

    def spy(points, verts, k=4, cull=None, stats=None, far_skip=0.0):
        assert far_skip == 0.0  # knn passes its (default) all-far skip on
        calls.append((k, cull, stats))
        return knn_exact_plain(points, verts, k)

    monkeypatch.setattr(knn_kernel, "knn_exact", spy)
    rng = np.random.default_rng(V)
    tv = torch.from_numpy(rng.normal(size=(1, V, 3)).astype(np.float32))
    tp = torch.from_numpy(rng.normal(size=(1, 50, 3)).astype(np.float32))
    for k in (4, 8):
        d, i = knn(tp, tv, k, packed=packed)
        assert d.shape == (1, k, 50)
    assert calls == [(4, True, None), (8, True, None)]


def test_knn_exact_on_the_cpu_ignores_cull_and_stats():
    """On CPU tensors ``knn_exact`` is its plain version whatever ``cull``
    says, and leaves ``stats`` alone (the kernel adds to it on the card)."""
    pts, verts = _grid_cloud(700, 300, seed=3)
    tp, tv = torch.from_numpy(pts), torch.from_numpy(verts)
    stats = torch.zeros(2, dtype=torch.int64)
    want = knn_exact_plain(tp, tv, 8)
    for cull in (True, False):
        got = knn_exact(tp, tv, 8, cull=cull, stats=stats)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert stats.tolist() == [0, 0]
