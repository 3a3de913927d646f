"""The port's exact kNN (kernel 9's plain version, the TPU kernel's slot
rule) above 16 neighbours against the JAX package on the CPU:
``knn_pallas(packed=False)`` in interpret mode at k_neigh 17, 24 and 32
(every k up to 32 is an instantiation of its own: the slot rule's order
is not total), ``knn_bruteforce`` at 40 (the run-time-k version; the
interpreted kernel takes ~100 s to trace at 40)."""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_knn_k import _cloud, _grid_cloud  # noqa: E402

from animnerf_tpu.ops.knn import knn_bruteforce  # noqa: E402
from animnerf_tpu.ops.knn_pallas import knn_pallas  # noqa: E402
from animnerf_tpu_torch.ops.knn_kernel import knn, knn_exact_plain  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("k", [17, 24, 32])
def test_exact_plain_is_knn_pallas_at_wide_k(k):
    """knn_exact_plain (kernel 9's plain version, the TPU kernel's slot
    rule) against _knn_kernel in interpret mode on a 1/64 grid: d2 exact
    in f32, so both see the same values and many exact ties, which the
    slot rule decides; distances and indices bit for bit."""
    pts, verts = _grid_cloud(1025, 259, seed=70 + k)
    dj, ij = knn_pallas(jnp.asarray(pts), jnp.asarray(verts), k=k,
                        packed=False, transposed_out=True, interpret=True)
    tp, tv = torch.from_numpy(pts), torch.from_numpy(verts)
    d, i = knn_exact_plain(tp, tv, k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(d.numpy(), np.asarray(dj))
    # the dispatcher: packed keys up to 8192 vertices, exact without them
    assert all(torch.equal(a, b) for a, b in zip(knn(tp, tv, k, packed=False),
                                                 (d, i)))
    assert knn(tp, tv, k)[0].shape == (1, k, 259)


def test_exact_plain_matches_bruteforce_at_40():
    """knn_exact_plain at k = 40 against knn_bruteforce (the JAX package's
    kNN off the TPU: |p|^2 + |v|^2 - 2 p.v and top_k) on a random cloud:
    the matmul form cancels, so squared distances agree within 1e-5 and
    indices agree except where two candidates lie within that of each
    other."""
    pts, verts = _cloud(V=1500, N=400, seed=41)
    dj, ij = (np.asarray(a) for a in knn_bruteforce(jnp.asarray(pts),
                                                    jnp.asarray(verts), 40))
    d, i = knn_exact_plain(torch.from_numpy(pts), torch.from_numpy(verts), 40)
    dt, it = d.numpy().transpose(0, 2, 1), i.numpy().transpose(0, 2, 1)
    assert dt.shape == dj.shape == (1, 400, 40)
    d2t, d2j = dt.astype(np.float64) ** 2, dj.astype(np.float64) ** 2
    assert np.abs(d2t - d2j).max() <= 1e-5
    diff = it != ij
    assert diff.mean() < 1e-2
    p = pts[0][np.nonzero(diff)[1]].astype(np.float64)
    da = ((p - verts[0][it[diff]]) ** 2).sum(-1)
    db = ((p - verts[0][ij[diff]]) ** 2).sum(-1)
    assert np.all(np.abs(da - db) <= 1e-5)
