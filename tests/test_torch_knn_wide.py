"""The run-time-k kNN kernels' design (kernels 8 and 9 above 16 / 23
neighbours, ``csrc/knn_wide.cuh``) on the CPU, against the plain versions
the card holds the kernels to bit for bit: the lane-strided bitonic sort
and fold, kernel 8's buffer-and-fold selection and kernel 9's per-point
cull, tile list and slot list, both kernels' nearest-first tiles and their
bounds (``ops/knn_wide.py``'s models, step for step) at k = 17, 32, 33, 40
and 64 (each list size) on a 1/64 tie grid and near random clouds; and the
dispatch that sends k above the thresholds to the new C entries."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from animnerf_tpu_torch.ops import _build, knn_kernel, knn_wide
from animnerf_tpu_torch.ops.knn_kernel import (
    knn,
    knn_exact,
    knn_exact_plain,
    knn_packed,
    knn_packed_plain,
)
from animnerf_tpu_torch.ops.warp_blend import morton_codes

torch.set_num_threads(1)


def _grid_cloud(V, N, seed):
    """Vertices and points on a 1/64 grid: d2 takes few values, so exact
    ties are everywhere, at the k-th neighbour too."""
    rng = np.random.default_rng(seed)
    verts = (rng.integers(-48, 49, size=(V, 3)) / 64).astype(np.float32)
    pts = (rng.integers(-56, 57, size=(N, 3)) / 64).astype(np.float32)
    return pts, verts


def _morton(x):
    order = torch.argsort(morton_codes(torch.from_numpy(x)[None])[0])
    return np.ascontiguousarray(x[order.numpy()])


@pytest.mark.parametrize("R", [1, 2, 4])
def test_lane_networks_sort_and_fold(R):
    """knn_wide::bitonic_sort sorts a lane-strided list of 32R keys (with
    its payload, keys unique) and fold keeps the 32R smallest of two
    sorted lists, ascending, sentinels and duplicates included."""
    rng = np.random.default_rng(R)
    n = 32 * R
    for _ in range(10):
        v = rng.integers(0, 50, size=(R, 32))
        np.testing.assert_array_equal(knn_wide.bitonic_sort(v).reshape(-1),
                                      np.sort(v.reshape(-1)))
        u = rng.permutation(10 * n)[:n].reshape(R, 32)
        s, p = knn_wide.bitonic_sort(u, 7 * u)
        np.testing.assert_array_equal(s.reshape(-1), np.sort(u.reshape(-1)))
        np.testing.assert_array_equal(p, 7 * s)
        a = np.sort(rng.integers(0, 4 * n, size=n)).reshape(R, 32)
        b = np.sort(np.concatenate([rng.integers(0, 4 * n, size=n // 2),
                                    np.full(n - n // 2, 1 << 40)]))
        np.testing.assert_array_equal(
            knn_wide.fold(a, b.reshape(R, 32)).reshape(-1),
            np.sort(np.concatenate([a.reshape(-1), b]))[:n])


@pytest.mark.parametrize("cloud", ["grid", "random"])
@pytest.mark.parametrize("k", [17, 32, 33, 40, 64])
def test_packed_wide_selection_is_the_plain_version(k, cloud):
    """Kernel 8's warp-per-point selection (Morton tiles nearest first by
    their key bound, stopped where the bound exceeds the k-th key; rows 32
    at a time, the keys below the list's k-th voted into the buffer, folds
    when it would overflow and at each tile's end) gives knn_packed_plain's
    keys bit for bit on the tie grid and on points near a random cloud,
    through several folds a point, skipping tiles on the latter."""
    pts, verts = _grid_cloud(1300, 24, seed=k)
    if cloud == "random":
        rng = np.random.default_rng(k)
        verts = _morton(rng.normal(scale=0.3, size=(3000, 3)).astype(
            np.float32))
        pts = (verts[rng.integers(0, len(verts), len(pts))]
               + rng.normal(scale=0.05, size=pts.shape)).astype(np.float32)
    d, i, folds, swept = knn_wide.packed_wide_model(pts, verts, k)
    dp, ip = knn_packed_plain(torch.from_numpy(pts)[None],
                              torch.from_numpy(verts)[None], k)
    np.testing.assert_array_equal(i, ip[0].numpy())
    np.testing.assert_array_equal(d, dp[0].numpy())
    assert folds >= 2 * len(pts)
    if cloud == "random":
        assert swept < len(pts) * len(verts)


@pytest.mark.parametrize("offset", [0.0, 30.0, 300.0])
def test_box_key_bound_is_below_every_key_in_the_box(offset):
    """The bound kernel 8 skips tiles by never exceeds a dot-form key of a
    vertex in the tile's box, also for clouds far from the origin, where
    the dot form's cancellation is large (kernel 1's deflated bound, 1e-4
    absolute, would not hold there)."""
    rng = np.random.default_rng(int(offset))
    verts = _morton((rng.normal(scale=0.3, size=(2000, 3)) + offset)
                    .astype(np.float32))
    pts = (verts[rng.integers(0, len(verts), 200)]
           + rng.normal(scale=0.2, size=(200, 3))).astype(np.float32)
    tv = torch.from_numpy(verts)[None]
    rows, order = knn_kernel.vertex_rows_plain(tv, stratified=False)
    keys = knn_wide.packed_keys(pts, rows, order)
    boxes = knn_kernel.tile_boxes(tv)[0].numpy()
    tile = knn_kernel.TILE_V
    pos = np.arange(keys.shape[1])
    real = order.numpy() < len(verts)
    bounded = 0
    for n, p in enumerate(pts):
        bound = knn_wide.box_key_bound(p, boxes)
        low = np.array([keys[n, (pos // tile == t) & real].min()
                        for t in range(len(boxes))])
        assert np.all(bound <= low)
        bounded += int((bound > 0).sum())
    assert bounded > 0


@pytest.mark.parametrize("cloud", ["grid", "random"])
@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("k", [17, 32, 33, 40, 64])
def test_exact_wide_selection_is_the_plain_version(k, cull, cloud):
    """Kernel 9's warp-per-point kernel gives knn_exact_plain's output bit
    for bit, ties included, on Morton-sorted vertices over five tiles: on
    random points its nearest-first pass (k + 1 smallest keys, tiles by
    their box bound, strictly ascending d2) answers every point; on the
    tie grid most points take the slot rule (the per-point sub-tile cull
    against the slot maximum, the tile list of the k smallest pairs below
    it through the buffer and folds, the i-th pair merged against the
    slot list's i-th element, the sort by (d2, slot)), which with the cull
    skips pairs. Its stats count every real pair of each pass once."""
    pts, verts = _grid_cloud(2100, 24, seed=k)
    if cloud == "random":
        rng = np.random.default_rng(k)
        verts = rng.normal(scale=0.3, size=verts.shape).astype(np.float32)
        pts = (verts[rng.integers(0, len(verts), len(pts))]
               + rng.normal(scale=0.05, size=pts.shape)).astype(np.float32)
    verts, pts = _morton(verts), _morton(pts)
    d, i, swept, skipped, slot_rule = knn_wide.exact_wide_model(
        pts, verts, k, cull)
    dp, ip = knn_exact_plain(torch.from_numpy(pts)[None],
                             torch.from_numpy(verts)[None], k)
    np.testing.assert_array_equal(i, ip[0].numpy())
    np.testing.assert_array_equal(d, dp[0].numpy())
    passes = len(pts) + slot_rule if k < knn_wide.CAP else len(pts)
    assert swept + skipped == passes * len(verts)
    if cloud == "random":
        assert slot_rule == 0 and skipped > 0
    else:
        assert slot_rule > len(pts) // 2
        if not cull:  # the nearest-first pass skips; the slot rule not
            assert skipped > 0


class _Recorder:
    """A kernel library that records the C entries called."""

    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        self.calls.append(name)


@pytest.mark.parametrize("k,packed_entry,exact_entry", [
    (8, "animnerf_knn_packed", "animnerf_knn_exact"),
    (16, "animnerf_knn_packed", "animnerf_knn_exact"),
    (17, "animnerf_knn_packed_wide", "animnerf_knn_exact"),
    (23, "animnerf_knn_packed_wide", "animnerf_knn_exact"),
    (24, "animnerf_knn_packed_wide", "animnerf_knn_exact_wide"),
    (33, "animnerf_knn_packed_wide", "animnerf_knn_exact_wide"),
    (128, "animnerf_knn_packed_wide", "animnerf_knn_exact_wide"),
    (200, "animnerf_knn_packed_wide", "animnerf_knn_exact_wide")])
def test_k_above_the_threshold_reaches_the_wide_entries(
        monkeypatch, k, packed_entry, exact_entry):
    """On a device tensor (here the meta device, with the library
    replaced by a recorder) ``knn`` sends k above PACKED_WIDE_ABOVE /
    EXACT_WIDE_ABOVE to the warp-per-point entries and counts the launch
    under both names; a route asks for either kernel."""
    lib = _Recorder()
    monkeypatch.setattr(_build, "kernel_library", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "check_cuda", lambda name, *t: None)
    _build.reset_launches()
    pts = torch.empty((1, 100, 3), device="meta")
    for V, entry, kind in ((6890, packed_entry, "knn_packed"),
                           (10475, exact_entry, "knn_exact")):
        lib.calls.clear()
        d, i = knn(pts, torch.empty((1, V, 3), device="meta"), k)
        assert d.shape == i.shape == (1, k, 100)
        assert lib.calls[-1] == entry
        assert _build.LAUNCHES[kind] == 1
        assert _build.LAUNCHES[f"{kind}_wide"] == int(entry.endswith("_wide"))
    verts = torch.empty((1, 6890, 3), device="meta")
    for fn, last in ((knn_packed, knn_kernel.PACKED_WIDE_ABOVE),
                     (knn_exact, knn_kernel.EXACT_WIDE_ABOVE)):
        lib.calls.clear()
        fn(pts, verts, k, route="wide")
        assert lib.calls[-1].endswith("_wide")
        if k <= last:  # the per-K instantiations end at the threshold
            fn(pts, verts, k, route="sweep")
            assert not lib.calls[-1].endswith("_wide")
        else:
            with pytest.raises(ValueError, match="route"):
                fn(pts, verts, k, route="sweep")
    assert (knn_kernel.PACKED_WIDE_ABOVE, knn_kernel.EXACT_WIDE_ABOVE) \
        == (16, 23)
    assert knn_wide.CAP == knn_kernel.WIDE_CAP
