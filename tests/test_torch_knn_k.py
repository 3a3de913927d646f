"""The port's kNN at k != 4 and its matmul-form kNN (plain versions)
against the JAX package on the CPU: the packed extract-min kernel
(``knn_pallas(packed=True, tournament=False)``), the exact kernel at k=8,
the dispatch by k, the kNN tool's ``knn_mxu`` (``tools/bench_knn.py``,
loaded by path) and the port's own tool."""

from __future__ import annotations

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animnerf_tpu.ops.knn_pallas import knn_pallas
from animnerf_tpu_torch.ops.knn_kernel import (
    knn,
    knn_exact_plain,
    knn_packed,
    knn_packed_plain,
    knn_top4_plain,
)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _cloud(V=1000, N=2048, seed=0):
    rng = np.random.default_rng(seed)
    verts = rng.normal(scale=0.3, size=(1, V, 3)).astype(np.float32)
    pts = (verts[:, rng.integers(0, V, N)]
           + rng.normal(scale=0.05, size=(1, N, 3))).astype(np.float32)
    return pts, verts


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


@pytest.mark.parametrize("k", [2, 8])
def test_knn_packed_plain_matches_extract_min_kernel(k):
    """knn_packed_plain against _packed_knn_kernel in interpret mode.
    XLA:CPU contracts the dot form's multiply-adds into FMAs (the TPU
    kernel and the port round every product), so a d2 within rounding of
    a key-quantum edge (2^-10 relative on d2) can land in the neighbouring
    quantum: indices agree except where two candidates' d2 fall within one
    quantum, distances agree to 1 ulp except on such edges, where their
    d2 differ by one quantum plus the dot form's cancellation (1e-6
    absolute: a few ulps of |p|^2 + |v|^2, which dominates near d2 = 0)."""
    pts, verts = _cloud(seed=11)
    dj, ij = knn_pallas(jnp.asarray(pts), jnp.asarray(verts), k=k,
                        packed=True, tournament=False, transposed_out=True,
                        interpret=True)
    dj, ij = np.asarray(dj), np.asarray(ij)
    dt, it = knn_packed(torch.from_numpy(pts), torch.from_numpy(verts), k)
    dt, it = dt.numpy(), it.numpy()
    assert dt.shape == dj.shape == (1, k, 2048) and it.dtype == np.int32
    diff = ij != it
    if diff.any():
        p = pts[0][np.nonzero(diff)[2]].astype(np.float64)
        d2a = ((p - verts[0][ij[diff]].astype(np.float64)) ** 2).sum(-1)
        d2b = ((p - verts[0][it[diff]].astype(np.float64)) ** 2).sum(-1)
        assert np.all(np.abs(d2a - d2b) <= 2.0 ** -10 * np.maximum(d2a, d2b)
                      + 1e-6)
    assert diff.mean() < 1e-3
    same = ~diff
    edge = same & (np.abs(dt - dj) > 2 * np.spacing(dj))
    assert edge.mean() < 0.05
    np.testing.assert_array_max_ulp(dt[same & ~edge], dj[same & ~edge],
                                    maxulp=1)
    d2t, d2j = dt.astype(np.float64) ** 2, dj.astype(np.float64) ** 2
    bound = 2.0 ** -10 * np.maximum(d2t, d2j) + 1e-6
    assert np.all(np.abs(d2t - d2j)[edge] <= bound[edge])
    assert np.all(np.diff(dt, axis=1) >= 0)


def _grid_cloud(V, N, seed):
    """Seeded vertices and points on a 1/64 grid (|x| <= 0.875): every
    product and sum of the dot form is then exact in f32, so XLA:CPU's FMA
    contraction changes no rounding and the keys are the TPU kernels'. d2
    takes few distinct values, so many keys share a quantum and the index
    bits break the ties."""
    rng = np.random.default_rng(seed)
    verts = (rng.integers(-48, 49, size=(1, V, 3)) / 64).astype(np.float32)
    pts = (rng.integers(-56, 57, size=(1, N, 3)) / 64).astype(np.float32)
    return pts, verts


@pytest.mark.parametrize("V", ["k", 1025, 8192])
@pytest.mark.parametrize("k", [1, 4, 8, 16])
def test_packed_plain_is_knn_pallas_bit_for_bit_at_edge_shapes(k, V):
    """The plain versions chip_smoke.py holds kernels 1 and 8 against,
    against knn_pallas in interpret mode at the shapes the sweep's tiling
    stresses: N = 259 (a multiple of no block's point count), V = k (one
    padded tile), 1025 (one real row in the last tile) and 8192 (the index
    field's limit). At k=4 the reference is the tournament kernel with its
    tile skip (kernel 1's), otherwise the extract-min kernel (kernel 8's).
    Distances and indices bit for bit (see _grid_cloud)."""
    V = k if V == "k" else V
    pts, verts = _grid_cloud(V, 259, seed=30 + k)
    dj, ij = knn_pallas(jnp.asarray(pts), jnp.asarray(verts), k=k,
                        packed=True, tournament=k == 4, tile_skip=k == 4,
                        transposed_out=True, interpret=True)
    tp, tv = torch.from_numpy(pts), torch.from_numpy(verts)
    d, i = knn_packed_plain(tp, tv, k)
    assert d.shape == (1, k, 259)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(d.numpy(), np.asarray(dj))
    if k == 4:
        for a, b in zip(knn_top4_plain(tp, tv), (d, i)):
            assert torch.equal(a, b)


def test_knn_packed_at_k4_is_the_top4():
    """Keys are unique, so the extract-min top-k at k=4 selects what the
    tournament's plain version selects: bit-equal, over several chunks."""
    pts, verts = _cloud(V=700, N=900, seed=12)
    tp, tv = torch.from_numpy(pts), torch.from_numpy(verts)
    a = knn_packed(tp, tv, 4)
    b = knn_top4_plain(tp, tv)
    c = knn_packed_plain(tp, tv, 4, max_elems=20000)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)
    # the first k of a larger k are the smaller k's (distinct keys)
    d8, i8 = knn_packed(tp, tv, 8)
    assert torch.equal(d8[:, :4], a[0]) and torch.equal(i8[:, :4], a[1])


def test_knn_exact_plain_k8_matches_exact_kernel():
    """knn_exact_plain at k=8 against _knn_kernel (packed=False, k=8) in
    interpret mode at V=10475: XLA:CPU's two FMA contractions of the d2
    sum, so distances agree within 2 ulps and indices agree except where
    two candidates' d2 lie within that rounding of each other."""
    pts, verts = _cloud(V=10475, N=1024, seed=13)
    dj, ij = knn_pallas(jnp.asarray(pts), jnp.asarray(verts), k=8,
                        packed=False, transposed_out=True, interpret=True)
    dj, ij = np.asarray(dj), np.asarray(ij)
    dt, it = knn_exact_plain(torch.from_numpy(pts), torch.from_numpy(verts),
                             8)
    dt, it = dt.numpy(), it.numpy()
    assert dt.shape == dj.shape == (1, 8, 1024) and it.dtype == np.int32
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


@pytest.mark.parametrize("V,k,want", [
    (700, 4, "top4"), (700, 8, "packed"), (700, 2, "packed"),
    (8193, 8, "exact"), (700, 16, "exact_unpacked")])
def test_knn_dispatches_by_k(V, k, want):
    """knn follows knn_pallas's choice: packed keys up to 8192 vertices
    (the top-4 tournament at k=4, the extract-min kernel at any other k),
    the exact kernel above it and with packed=False."""
    pts, verts = _cloud(V=V, N=150, seed=14)
    tp, tv = torch.from_numpy(pts), torch.from_numpy(verts)
    packed = want != "exact_unpacked"
    got = knn(tp, tv, k, tile_skip=True, packed=packed)
    ref = {"top4": lambda: knn_top4_plain(tp, tv),
           "packed": lambda: knn_packed_plain(tp, tv, k)}.get(
        want, lambda: knn_exact_plain(tp, tv, k))()
    assert got[0].shape == (1, k, 150)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_knn_rejects_k_outside_1_to_16():
    """k = 0 and k > V are refused (every k from 1 to V is taken: 17 and
    V itself here)."""
    pts, verts = _cloud(V=100, N=10, seed=15)
    tp, tv = torch.from_numpy(pts), torch.from_numpy(verts)
    for packed in (True, False):
        with pytest.raises(ValueError, match="at least 1"):
            knn(tp, tv, 0, packed=packed)
        with pytest.raises(ValueError, match="V"):
            knn(tp, tv, 101, packed=packed)
        for k in (17, 100):
            assert knn(tp, tv, k, packed=packed)[1].shape == (1, k, 10)
    with pytest.raises(ValueError, match="V"):
        knn(tp, tv[:, :5].contiguous(), 8)


# ------------------------------------------------------ matmul-form kNN


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_knn", ROOT / "tools" / "bench_knn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_knn_mxu_plain_matches_the_tool_at_highest():
    """knn_mxu_plain("highest") against the tool's knn_mxu at HIGHEST in
    interpret mode: the same centred rows and top-4 rule; XLA:CPU's dot
    and mean sum in their own order, so d2 differs by a few ulps of
    |p|^2 + |v|^2 (~1): distances within 1e-5 and indices equal except
    between candidates whose d2 lie within that of each other."""
    from animnerf_tpu_torch.ops.knn_mxu import knn_mxu

    pts, verts = _cloud(V=1000, N=1024, seed=16)
    dj, ij = _jax_tool().knn_mxu(jnp.asarray(pts), jnp.asarray(verts), k=4,
                                 interpret=True,
                                 precision=jax.lax.Precision.HIGHEST)
    dj, ij = np.asarray(dj), np.asarray(ij)
    dt, it = knn_mxu(torch.from_numpy(pts), torch.from_numpy(verts))
    dt, it = dt.numpy(), it.numpy()
    assert dt.shape == dj.shape == (1, 1024, 4) and it.dtype == np.int32
    diff = ij != it
    if diff.any():
        p = pts[0][np.nonzero(diff)[1]].astype(np.float64)
        d2a = ((p - verts[0][ij[diff]]) ** 2).sum(-1)
        d2b = ((p - verts[0][it[diff]]) ** 2).sum(-1)
        assert np.all(np.abs(d2a - d2b) <= 1e-5)
    assert diff.mean() < 1e-3
    np.testing.assert_allclose(dt[~diff], dj[~diff], atol=1e-5)
    assert np.all(np.diff(dt, axis=-1) >= 0)


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def test_knn_mxu_plain_default_rounds_operands_to_bf16():
    """"default": the rows rounded to bf16 (to nearest even), the 8 exact
    products summed left to right in f32, the tool's top-4 rule: bit for
    bit against a numpy emulation (XLA:CPU keeps f32 operands at
    Precision.DEFAULT, so the JAX tool is no reference here)."""
    from test_torch_knn import _tpu_slots_topk

    from animnerf_tpu_torch.ops.knn_mxu import augmented_rows, knn_mxu_plain

    pts, verts = _cloud(V=700, N=200, seed=17)
    tp, tv = torch.from_numpy(pts), torch.from_numpy(verts)
    d, i = knn_mxu_plain(tp, tv, precision="default", max_elems=30000)
    P, A = (x.numpy() for x in augmented_rows(tp, tv))
    c = verts.mean(axis=1, keepdims=True)
    np.testing.assert_allclose(P[0, :3].T, (pts - c)[0], atol=1e-6)
    P, A = _bf16(P[0]), _bf16(A[0])                 # (8, N), (V, 8)
    d2 = A[None, :, 0] * P[0][:, None]
    for col in range(1, 8):
        d2 = d2 + A[None, :, col] * P[col][:, None]
    want = [_tpu_slots_topk(row, 4) for row in d2]
    np.testing.assert_array_equal(i.numpy()[0], [w[1] for w in want])
    wd = np.sqrt(np.maximum(np.stack([w[0] for w in want]), 0)
                 .astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(d.numpy()[0], wd)
    hi = knn_mxu_plain(tp, tv, precision="highest")
    assert not torch.equal(hi[0], d)  # the rounding shows


def test_knn_mxu_rejects_other_k_and_precisions():
    from animnerf_tpu_torch.ops.knn_mxu import knn_mxu

    pts, verts = _cloud(V=100, N=10, seed=18)
    tp, tv = torch.from_numpy(pts), torch.from_numpy(verts)
    with pytest.raises(ValueError, match="top-4"):
        knn_mxu(tp, tv, k=8)
    with pytest.raises(ValueError, match="precision"):
        knn_mxu(tp, tv, precision="high")


def test_bench_knn_tool_runs_on_the_cpu(capsys):
    """The port's tool at a small size on the CPU: every row of the JAX
    tool and its correctness lines, the extract-min and tournament
    variants bit-equal, the matmul form at "highest" close to exact."""
    from animnerf_tpu_torch.tools import bench_knn

    rows = bench_knn.run("cpu", B=2, N=300, reps=1)
    names = [r.get("row") for r in rows if "row" in r]
    assert names == ["exact kNN", "min distance", "packed extract-min",
                     "packed tournament", "mxu highest", "mxu default"]
    assert all(r["host_ms"] > 0 and "ms" not in r for r in rows if "row" in r)
    checks = {r["check"]: r for r in rows if "check" in r}
    bit = checks["tournament vs extract-min bit-equal"]
    assert bit["d"] and bit["i"]
    assert checks["mxu highest vs exact"]["max_abs_d_err"] < 1e-4
    assert checks["packed vs exact"]["max_rel_d_err"] < 2e-3
    assert bench_knn.main(["--device", "cpu", "--batch", "1", "--points",
                           "64", "--reps", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == len(rows)
    # the inputs are the JAX tool's draws
    verts, sets = bench_knn.make_inputs(2, 300)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        verts, rng.normal(scale=0.3, size=(2, 6890, 3)).astype(np.float32))
    assert len(sets) == bench_knn.N_SETS and sets[0].shape == (2, 300, 3)
