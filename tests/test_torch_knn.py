"""The port's packed top-4 kNN (plain version) against the TPU tournament
kernel ``knn_pallas(packed=True)`` in interpret mode, on the CPU."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
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
    assert box.shape == (1, 3, 8)
    for t in range(3):
        v = verts[0, t * TILE_V:(t + 1) * TILE_V]
        np.testing.assert_array_equal(box[0, t, :3], v.min(0))
        np.testing.assert_array_equal(box[0, t, 3:6], v.max(0))


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
