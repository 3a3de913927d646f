"""The port's signed point-to-mesh distance (``ops/mesh_distance.py``,
torch float64) against the JAX package's numpy version, on the CPU.

Bounds: distances within 1e-12 relative (the two compute the same
operations; the port sums each 3-term dot product in numpy's einsum
order, so most distances are bit-equal), signs equal everywhere.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from animnerf_tpu.ops.mesh_distance import signed_distance as jax_sd
from animnerf_tpu_torch.data.synthetic import make_rig
from animnerf_tpu_torch.ops.mesh_distance import (
    chunk_points,
    signed_distance,
)

torch.set_num_threads(1)

REL = 1e-12


def uv_sphere():
    """tests/test_tools.py's closed unit UV sphere, faces outward."""
    th = np.linspace(0, np.pi, 9)[1:-1]
    ph = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    pts = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp),
                    np.cos(tt)], -1).reshape(-1, 3)
    verts = np.concatenate([pts, [[0, 0, 1.0]], [[0, 0, -1.0]]])
    faces = []
    R, C = tt.shape
    for i in range(R - 1):
        for j in range(C):
            a, b = i * C + j, i * C + (j + 1) % C
            c, d = (i + 1) * C + j, (i + 1) * C + (j + 1) % C
            faces += [[a, b, c], [b, d, c]]
    top, bot = len(verts) - 2, len(verts) - 1
    for j in range(C):
        faces.append([top, (j + 1) % C, j])
        faces.append([bot, (R - 1) * C + j, (R - 1) * C + (j + 1) % C])
    faces = np.asarray(faces)
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    flip = (np.cross(b - a, c - a) * (a + b + c) / 3).sum(-1) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return verts, faces


def _check(points, verts, faces, **kw):
    want = jax_sd(points, verts, faces, chunk=256)
    got = signed_distance(points, verts, faces, **kw)
    assert got.dtype == torch.float64 and got.shape == want.shape
    got = got.numpy()
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    return got


def test_sphere_matches_jax_and_its_signs():
    """The four sign assertions of tests/test_tools.py, then 2,000 random
    points in and around the sphere against the JAX version."""
    verts, faces = uv_sphere()
    q = np.array([[0, 0, 0], [0.5, 0, 0], [2.0, 0, 0], [0, 1.5, 0]],
                 np.float64)
    d = _check(q, verts, faces)
    assert d[0] < -0.8 and d[1] < 0 and 0.8 < d[2] < 1.2 and 0.3 < d[3] < 0.7
    pts = np.random.default_rng(0).uniform(-1.5, 1.5, size=(2000, 3))
    d = _check(pts, verts, faces)
    assert (d < 0).sum() > 100 and (d > 0).sum() > 100


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_rig_matches_jax(seed):
    """A 300-vertex seeded rig with its strip faces (many shared edges and
    vertices, so ties between faces are frequent), 3,000 points about it;
    the chunk by memory or by count gives the same result bit for bit."""
    rig = make_rig(300, 12, seed=seed)
    verts, faces = rig["v_template"], rig["faces"]
    pts = np.random.default_rng(seed + 1).uniform(-0.5, 0.8, size=(3000, 3))
    a = _check(pts, verts, faces, max_bytes=1 << 22)
    b = signed_distance(torch.from_numpy(pts), verts, faces, chunk=97)
    np.testing.assert_array_equal(a, b.numpy())
    assert chunk_points(len(faces), 1 << 22) == (1 << 22) // (len(faces) * 24)


def test_points_on_an_edge_and_a_vertex():
    """A tetrahedron on integer coordinates: points exactly on a vertex,
    on an edge's midpoint and on a face have distance 0 and sign +1 (the
    JAX convention for a zero offset); points just off them along the
    outward and inward directions get the JAX version's signs."""
    verts = np.array([[0, 0, 0], [2, 0, 0], [0, 2, 0], [0, 0, 2]], np.float64)
    faces = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]])
    on = np.array([[2, 0, 0], [1, 1, 0], [1, 0, 1], [0.5, 0.5, 0]],
                  np.float64)
    d = _check(on, verts, faces)
    assert np.all(d == 0) and not np.signbit(d).any()
    centroid = verts.mean(0)
    off = np.concatenate([on + 1e-3 * (on - centroid),
                          on - 1e-3 * (on - centroid)])
    d = _check(off, verts, faces)
    assert (d[:4] > 0).all() and (d[4:] < 0).all()


def test_inside_positive_convention_flips():
    verts, faces = uv_sphere()
    q = np.array([[0.0, 0, 0], [2.0, 0, 0]])
    a = signed_distance(q, verts, faces)
    b = signed_distance(q, verts, faces, sign_convention="inside_positive")
    assert torch.equal(a, -b)
