"""The kNN's all-far skip (``far_skip``, the TPU kernels' ``far2``) in the
port's plain versions against ``knn_pallas(..., far_skip=thr)`` in
interpret mode on the CPU, and against a numpy reference that rounds
every operation on its own.

Kernels: 1 (``knn_top4``, ``tournament`` on, with and without
``tile_skip``), 8 (``knn_packed``, ``tournament=False`` at k=4) and 9
(``knn_exact``, ``packed=False`` with its cull), at ``knn_pallas``'s
default tiles (1024-point groups, 512-vertex boxes), transposed output.

Vertices and the points of the groups that sweep lie on a 1/64 grid, so
every product and sum is exact and XLA:CPU's FMA contraction changes no
rounding there: those outputs are bit-equal. Some cases put their far
points off the grid; there XLA:CPU contracts the bound's
``lb2 + gap * gap`` into an FMA, which the TPU and the port round
separately, so a skipped point's distance is held within 2 ulps (exact
kernel: sqrt of the bound) or one key quantum (packed kernels: the bound
rounded up to a 2^13-ulp quantum of d2) of JAX. Each case asserts that
every group's smallest bound lies more than 8 ulps from far2, so that
such a rounding cannot flip a skip decision.
"""

from __future__ import annotations

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animnerf_tpu.ops.knn_pallas import knn_pallas
from animnerf_tpu_torch.ops import _build
from animnerf_tpu_torch.ops.knn_kernel import (
    FAR_GROUP,
    _far_pass,
    far_groups_plain,
    far_threshold,
    knn,
    knn_exact,
    knn_exact_plain,
    knn_packed,
    knn_packed_plain,
    knn_top4,
)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TILE_V = 512
KEY_QUANTUM = 0x2000  # the packed keys' 13 dropped mantissa bits


def _grid(x):
    return (np.round(x * 64) / 64).astype(np.float32)


def _case(name):
    """(points (B, N, 3), verts (B, V, 3), thr) of a named case."""
    rng = np.random.default_rng(sum(map(ord, name)))

    def cloud(V, B=1, shift=0.0):
        return _grid(rng.normal(scale=0.2, size=(B, V, 3)) + shift)

    def near(n, B=1, shift=0.0):
        return _grid(rng.normal(scale=0.25, size=(B, n, 3)) + shift)

    def far(n, B=1, grid=True, shift=5.0):
        x = rng.normal(scale=0.25, size=(B, n, 3)) + shift
        return _grid(x) if grid else x.astype(np.float32)

    g = FAR_GROUP
    if name == "near_far":  # test_knn_warp.py:294-318, 1024-point groups
        return np.concatenate([near(g), far(g)], 1), cloud(600), 0.2
    if name == "near_far_offgrid":  # the same with off-grid far points
        return np.concatenate([near(g), far(g, grid=False)], 1), \
            cloud(600), 0.2
    if name == "random_b2":  # test_knn_warp.py:587-600: nothing skips
        return _grid(rng.normal(size=(2, 3 * g, 3))), \
            _grid(rng.normal(size=(2, 700, 3))), 0.5
    if name == "b2_mixed":  # batch 0 skips group 0, batch 1 group 1
        p = np.concatenate([np.concatenate([far(g), near(g)], 1),
                            np.concatenate([near(g), far(g, grid=False)], 1)])
        return p, cloud(700, B=2), 0.2
    if name == "partial_origin":
        # N = 2500: the last group's 452 real points are far, but its 572
        # padding points sit at the origin, inside the cloud's boxes
        return far(2500), cloud(600), 0.2
    if name == "partial_away":
        # the cloud away from the origin: the padding is far too, and the
        # last group skips
        return far(2500, shift=-5.0), cloud(600, shift=3.0), 0.2
    if name == "smplx":  # V = 10475: the exact kernel
        return np.concatenate([near(g), far(g, grid=False)], 1), \
            cloud(10475), 0.2
    if name == "smpl":  # V = 6890 (kernel 8 at k = 8)
        return np.concatenate([far(g, grid=False), near(g)], 1), \
            cloud(6890), 0.2
    raise KeyError(name)


def np_far(pts, verts, thr):
    """numpy reference of the far pass, every operation rounded on its
    own: (g_lb2 (B, N), skip (B, G), smallest bound per group, far2)."""
    B, N, _ = pts.shape
    V = verts.shape[1]
    nt = -(-V // TILE_V)
    G = -(-N // FAR_GROUP)
    p = np.concatenate([pts, np.zeros((B, G * FAR_GROUP - N, 3),
                                      np.float32)], 1)
    g = np.full((B, p.shape[1]), np.inf, np.float32)
    for t in range(nt):
        v = verts[:, t * TILE_V:(t + 1) * TILE_V]
        lo, hi = v.min(1), v.max(1)                               # (B, 3)
        lb2 = np.zeros_like(g)
        for a in range(3):
            gap = np.maximum(np.maximum(lo[:, a:a + 1] - p[..., a],
                                        p[..., a] - hi[:, a:a + 1]),
                             np.float32(0))
            lb2 = lb2 + gap * gap
        g = np.minimum(g, lb2)
    gmin = g.reshape(B, G, FAR_GROUP).min(-1)
    far2 = np.float32(float(thr) ** 2)
    return g[:, :N], gmin > far2, gmin, far2


def np_bound_outputs(g, k, packed):
    """A skipped point's distance (B, k, N) from its bound."""
    if packed:
        g = (((g.view(np.int32) & ~0x1FFF) + KEY_QUANTUM) & ~0x1FFF
             ).view(np.float32)
    d = np.sqrt(g.astype(np.float64)).astype(np.float32)
    return np.broadcast_to(d[:, None], (g.shape[0], k, g.shape[1]))


# kernel -> (port call, knn_pallas options, packed keys)
KERNELS = {
    "k1": (lambda p, v, k, fs: knn_top4(p, v, far_skip=fs),
           dict(packed=True), True),
    "k1_tile_skip": (lambda p, v, k, fs: knn_top4(p, v, tile_skip=True,
                                                  far_skip=fs),
                     dict(packed=True, tile_skip=True), True),
    "k8": (lambda p, v, k, fs: knn_packed(p, v, k, far_skip=fs),
           dict(packed=True, tournament=False), True),
    "k9": (lambda p, v, k, fs: knn_exact(p, v, k, far_skip=fs),
           dict(packed=False, cull=True), False),
}


@pytest.mark.parametrize("case,kernel,k", [
    ("near_far", "k1", 4),
    ("near_far", "k1_tile_skip", 4),
    ("near_far", "k8", 4),
    ("near_far", "k9", 4),
    ("near_far_offgrid", "k1", 4),
    ("near_far_offgrid", "k9", 4),
    ("random_b2", "k1_tile_skip", 4),
    ("random_b2", "k8", 4),
    ("b2_mixed", "k1", 4),
    ("b2_mixed", "k8", 8),
    ("b2_mixed", "k9", 4),
    ("partial_origin", "k1", 4),
    ("partial_origin", "k9", 8),
    ("partial_away", "k8", 2),
    ("partial_away", "k9", 4),
    ("smplx", "k9", 4),
    ("smplx", "k9", 8),
    ("smpl", "k8", 8),
])
def test_far_skip_plain_matches_knn_pallas(case, kernel, k):
    pts, verts, thr = _case(case)
    call, opts, packed = KERNELS[kernel]
    g, skip, gmin, far2 = np_far(pts, verts, thr)
    # no group's bound within 8 ulps of far2: FMA rounding cannot flip it
    assert (np.abs(gmin - far2) > 8 * np.spacing(far2)).all()
    pt, vt = torch.from_numpy(pts), torch.from_numpy(verts)

    # the port's decisions are the numpy reference's
    gt, st = far_groups_plain(pt, vt, thr)
    np.testing.assert_array_equal(gt.numpy(), g)
    np.testing.assert_array_equal(st.numpy(), skip)

    dt, it = (x.numpy() for x in call(pt, vt, k, thr))
    d0, i0 = (x.numpy() for x in call(pt, vt, k, 0.0))
    dj, ij = knn_pallas(jnp.asarray(pts), jnp.asarray(verts), k=k,
                        tile_n=FAR_GROUP, tile_v=TILE_V, far_skip=thr,
                        transposed_out=True, interpret=True, **opts)
    dj, ij = np.asarray(dj), np.asarray(ij)

    N = pts.shape[1]
    skip_pt = np.repeat(skip, FAR_GROUP, axis=1)[:, :N]          # (B, N)
    sk = np.broadcast_to(skip_pt[:, None], dt.shape)
    # the plain version against numpy: the bound outputs where skipped,
    # the unskipped sweep's elsewhere, bit for bit
    np.testing.assert_array_equal(dt[sk], np_bound_outputs(g, k, packed)[sk])
    np.testing.assert_array_equal(it[sk], 0)
    np.testing.assert_array_equal(dt[~sk], d0[~sk])
    np.testing.assert_array_equal(it[~sk], i0[~sk])

    # against the TPU kernel: the same indices (so the same decisions:
    # a swept group has k distinct indices), swept distances bit-equal
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt[~sk], dj[~sk])
    if packed:  # within one key quantum of d2
        q = (dt[sk].astype(np.float64) ** 2 - dj[sk].astype(np.float64) ** 2)
        ulp = np.spacing(dj[sk].astype(np.float32) ** 2).astype(np.float64)
        assert (np.abs(q) <= KEY_QUANTUM * ulp * 1.01).all()
    else:  # within 2 ulps
        ulps = np.abs(dt[sk].view(np.int32).astype(np.int64)
                      - dj[sk].view(np.int32))
        assert ulps.max(initial=0) <= 2
    # every skipped distance exceeds the threshold: the warp marks the
    # point invalid, as the unskipped sweep does
    assert (dt[sk] > np.float32(thr)).all()
    np.testing.assert_array_equal(dt < np.float32(thr), d0 < np.float32(thr))
    if case == "random_b2":
        assert not skip.any()
    elif case == "partial_origin":
        assert skip[0].tolist() == [True, True, False]
    elif case == "partial_away":
        assert skip[0].tolist() == [True, True, True]
    elif case == "b2_mixed":
        assert skip.tolist() == [[True, False], [False, True]]
    else:
        assert skip.any() and not skip.all()


def test_far_threshold_rounds_the_double_square_once():
    """far2 is float32(thr ** 2), squared in double (knn_pallas.py:603-615):
    at thr = 0.2 that is one ulp below float32(0.2) squared in float32."""
    assert far_threshold(0.2) == float(np.float32(0.2 ** 2))
    assert far_threshold(0.2) != float(np.float32(0.2) * np.float32(0.2))
    assert far_threshold(0.25) == 0.0625


@pytest.mark.parametrize("fn", ["top4", "top4_tile_skip", "packed", "exact",
                                "knn"])
def test_far_skip_zero_is_the_unskipped_kernel(fn):
    """far_skip = 0 leaves every output as it was without the option."""
    pts, verts, _ = _case("near_far_offgrid")
    p, v = torch.from_numpy(pts), torch.from_numpy(verts)
    calls = {
        "top4": (lambda **kw: knn_top4(p, v, **kw),
                 lambda: knn_packed_plain(p, v, 4)),
        "top4_tile_skip": (lambda **kw: knn_top4(p, v, tile_skip=True, **kw),
                           lambda: knn_packed_plain(p, v, 4)),
        "packed": (lambda **kw: knn_packed(p, v, 8, **kw),
                   lambda: knn_packed_plain(p, v, 8)),
        "exact": (lambda **kw: knn_exact(p, v, 8, **kw),
                  lambda: knn_exact_plain(p, v, 8)),
        "knn": (lambda **kw: knn(p, v, 4, **kw),
                lambda: knn_packed_plain(p, v, 4)),
    }
    call, ref = calls[fn]
    for a, b in zip(call(far_skip=0.0), ref()):
        assert torch.equal(a, b)


def test_far_pass_launches_nothing_at_zero(monkeypatch):
    """With far_skip = 0 the wrappers run no far pass (no extra launch)."""
    def no_build():
        raise AssertionError("far_skip = 0 must not reach a kernel")

    monkeypatch.setattr(_build, "kernel_library", no_build)
    p = torch.zeros(1, 8, 3)
    assert _far_pass(p, p, 0.0, None, None, packed=True) is None


def test_knn_dispatch_passes_far_skip():
    """``knn`` hands far_skip to the kernel it picks (k = 4 packed, k = 8
    packed, the exact kernel above 8192 vertices)."""
    pts, verts, thr = _case("near_far")
    p, v = torch.from_numpy(pts), torch.from_numpy(verts)
    for k, packed in ((4, True), (8, True), (4, False)):
        d, i = knn(p, v, k, packed=packed, far_skip=thr)
        assert (i[:, :, FAR_GROUP:] == 0).all()
        assert (d[:, :, FAR_GROUP:] > thr).all()
        d0, _ = knn(p, v, k, packed=packed)
        assert torch.equal(d[:, :, :FAR_GROUP], d0[:, :, :FAR_GROUP])


def _c_entries():
    """extern "C" entry points of csrc/*.cu -> their parameter types."""
    out = {}
    for path in sorted((ROOT / "animnerf_tpu_torch" / "csrc").glob("*.cu")):
        text = path.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            out[m.group(1)] = [a.strip() for a in m.group(2).split(",")
                               if a.strip()]
    return out


def test_c_entry_signatures_match_the_ctypes_bindings():
    """Every bound C entry's parameters agree with its ctypes signature in
    ``_build.SIGNATURES`` (pointers as c_void_p, ints as c_int, floats as
    c_float): the kernels build only on the card, so a mismatch would
    first show there."""
    import ctypes

    entries = _c_entries()
    assert set(_build.SIGNATURES) <= set(entries)
    for name, argtypes in _build.SIGNATURES.items():
        want = [ctypes.c_void_p if "*" in a else
                ctypes.c_float if a.startswith("float") else ctypes.c_int
                for a in entries[name]]
        assert argtypes == want, name
