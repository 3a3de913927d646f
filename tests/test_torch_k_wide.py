"""The port's packed kNN, warp-blend and weighted scatter above 16
neighbours (k_neigh 17, 24, 32, 40, and 64 for the warp-blend, which
runs its group kernel there on the card) against the JAX package on
the CPU: the plain versions against ``knn_pallas``'s extract-min kernel
and the warp-blend and scatter TPU kernels in interpret mode (the exact
kNN: tests/test_torch_k_wide_exact.py)."""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_knn_k import _grid_cloud  # noqa: E402

from animnerf_tpu.ops.knn_pallas import knn_pallas  # noqa: E402
from animnerf_tpu_torch.ops.blend import weighted_scatter_rows  # noqa: E402
from animnerf_tpu_torch.ops.knn_kernel import knn_packed_plain  # noqa: E402
from animnerf_tpu_torch.ops.warp_blend import warp_blend_fwd  # noqa: E402

torch.set_num_threads(1)

WIDE_K = [17, 24, 32, 40]


@pytest.mark.parametrize("k", WIDE_K)
def test_packed_plain_is_knn_pallas_at_wide_k(k):
    """knn_packed_plain (kernel 8's plain version) against the extract-min
    kernel in interpret mode on a 1/64 grid (every product of the dot
    form exact, so the keys are the TPU kernel's): distances and indices
    bit for bit, 259 points, 1025 vertices (a last tile of one row)."""
    pts, verts = _grid_cloud(1025, 259, seed=60 + k)
    dj, ij = knn_pallas(jnp.asarray(pts), jnp.asarray(verts), k=k,
                        packed=True, tournament=False, transposed_out=True,
                        interpret=True)
    d, i = knn_packed_plain(torch.from_numpy(pts), torch.from_numpy(verts), k)
    assert d.shape == (1, k, 259)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(d.numpy(), np.asarray(dj))


def _table(verts, num_lbs, seed):
    """Seeded table rows [lbs | 4x4]: one-hot LBS weights by a vertex's
    x band, so that the confidence gate opens for neighbours in the
    point's band and closes for the others."""
    V = verts.shape[1]
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(1, V, num_lbs + 16)).astype(np.float32)
    band = np.floor((verts[0, :, 0] + 1.0) * 4.0).astype(np.int64) % num_lbs
    t[0, :, :num_lbs] = np.eye(num_lbs, dtype=np.float32)[band]
    return t


@pytest.mark.parametrize("k", WIDE_K + [64])
def test_warp_blend_plain_matches_kernel_at_wide_k(k):
    """warp_blend_fwd_plain with k neighbour rows against the TPU
    warp-blend kernel in interpret mode on the packed kNN's k neighbours
    (also at 64, which the card's group kernel takes as it takes 17-40):
    the sums over k in the same order, f32 rounding only (atol 1e-5, the
    k = 2, 8 tests' bound)."""
    from animnerf_tpu.ops.warp_blend import warp_blend_fwd_pallas

    N, V, L = 300, 700, 24
    rng = np.random.default_rng(80 + k)
    verts = rng.normal(scale=0.3, size=(1, V, 3)).astype(np.float32)
    pts = (verts[:, rng.integers(0, V, N)]
           + rng.normal(scale=0.05, size=(1, N, 3))).astype(np.float32)
    d, i = knn_packed_plain(torch.from_numpy(pts), torch.from_numpy(verts), k)
    table = _table(verts, L, 90 + k)
    rows = np.zeros((1, 8, N), np.float32)
    rows[0, :3] = pts[0].T
    ja = warp_blend_fwd_pallas(jnp.asarray(rows), None, jnp.asarray(d.numpy()),
                               jnp.asarray(i.numpy()), jnp.asarray(table), L,
                               0.5, 0.3, interpret=True, tile_n=256,
                               inputs_t=True, xyz_rows=True)
    ta = warp_blend_fwd(torch.from_numpy(rows), d, i,
                        torch.from_numpy(table), L, 0.5, 0.3)
    assert ta[1].shape == (1, k, N)
    for name, a, b in zip(("out", "w", "bf"), ja, ta):
        np.testing.assert_allclose(b.numpy(), np.asarray(a)[..., :N],
                                   atol=1e-5, err_msg=name)
    w = ta[1].numpy()
    assert (w == 0).any() and (w[:, 1:] > 0).any()


@pytest.mark.parametrize("k", WIDE_K)
def test_weighted_scatter_plain_matches_kernel_at_wide_k(k):
    """weighted_scatter_rows_plain with k neighbour rows against the TPU
    scatter kernel in interpret mode: f32 sums in another order,
    rtol/atol 1e-5 (the k = 2, 8 tests' bound)."""
    from animnerf_tpu.ops.blend import weighted_scatter_rows_pallas

    B, N, V = 2, 300, 1024
    rng = np.random.default_rng(100 + k)
    idx = rng.integers(100, 140, size=(B, k, N)).astype(np.int32)
    idx[..., ::31] = rng.integers(V - 20, V, size=idx[..., ::31].shape)
    w = rng.uniform(size=(B, k, N)).astype(np.float32)
    g = rng.normal(size=(B, 16, N)).astype(np.float32)
    ref = np.asarray(weighted_scatter_rows_pallas(
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(g), V, tile_n=128,
        tile_v=256, interpret=True, transposed_in=True, g_t=True))
    got = weighted_scatter_rows(*(torch.from_numpy(a) for a in (idx, w, g)),
                                V)
    assert got.shape == (B, V, 16)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
