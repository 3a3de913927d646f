"""The port's frame geometry, ray cull and warp-blend (plain version)
against the JAX package, on the CPU."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animnerf_tpu.data.synthetic import make_body_model as j_make
from animnerf_tpu.data.synthetic import random_pose_params
from animnerf_tpu.models import warp as JW
from animnerf_tpu.ops.knn_pallas import knn_pallas
from animnerf_tpu.ops.warp_blend import morton_codes as j_morton
from animnerf_tpu.ops.warp_blend import warp_blend_fwd_pallas
from animnerf_tpu_torch.data.synthetic import make_body_model as t_make
from animnerf_tpu_torch.models import warp as TW
from animnerf_tpu_torch.ops.warp_blend import (
    morton_codes,
    warp_blend_fwd,
)

torch.set_num_threads(1)

V, J = 256, 24


def _frame():
    bp = random_pose_params(J, batch=1, seed=11)
    tmpl = random_pose_params(J, batch=1, seed=12)
    tmpl["transl"] = np.zeros_like(tmpl["transl"])
    jctx = JW.prepare_frame(j_make(V, J, seed=6),
                            {k: jnp.asarray(v) for k, v in bp.items()},
                            {k: jnp.asarray(v) for k, v in tmpl.items()})
    tctx = TW.prepare_frame(t_make(V, J, seed=6),
                            {k: torch.from_numpy(v) for k, v in bp.items()},
                            {k: torch.from_numpy(v) for k, v in tmpl.items()})
    return jctx, tctx


def _np(ctx, k):
    return np.asarray(getattr(ctx, k))


def test_prepare_frame_matches():
    jctx, tctx = _frame()
    for k in ("verts", "joints", "ober2cano", "root_inv", "verts_template"):
        # f32 compose -> inverse -> compose chain: rounding only
        np.testing.assert_allclose(getattr(tctx, k).numpy(), _np(jctx, k),
                                   atol=1e-5, err_msg=k)
    jv, jt = JW._morton_inputs(jctx)  # the fused-warp inputs, built inline
    np.testing.assert_allclose(tctx.verts_morton.numpy(), np.asarray(jv),
                               atol=1e-5)
    np.testing.assert_allclose(tctx.table_morton.numpy(), np.asarray(jt),
                               atol=1e-5)


def test_morton_inputs_exact_on_same_geometry():
    """Given the same vertex cloud, codes, the stable sort and the table
    permutation are bit-identical."""
    jctx, _ = _frame()
    codes = morton_codes(torch.tensor(_np(jctx, "verts")))
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(j_morton(jctx.verts)).astype(np.int64))
    tctx = TW.FrameContext(**{k: torch.tensor(_np(jctx, k)) for k in (
        "verts", "joints", "ober2cano", "root_inv", "verts_template",
        "lbs_weights")})
    tv, tt = TW._morton_inputs(tctx)
    jv, jt = JW._morton_inputs(jctx)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def _ray_grid(n=32):
    from animnerf_tpu_torch.ops.ray_utils import camera_to_c2w, gen_rays

    c2w = camera_to_c2w(np.eye(3), np.array([0.0, 0.0, 3.0]))
    return gen_rays(c2w, n, n, [1.2 * n, 1.2 * n], 0.1, 10.0).reshape(1, -1, 8)


def test_rays_to_root_frame_and_ray_cull_match():
    from __graft_entry__ import _flagship_system
    from animnerf_tpu.render.inference import Renderer as JR
    from animnerf_tpu.render.inference import turntable_rotation as j_turn
    from animnerf_tpu_torch.render.inference import Renderer as TR
    from animnerf_tpu_torch.render.inference import turntable_rotation
    from animnerf_tpu_torch.system import AnimNeRFSystem

    jctx, tctx = _frame()
    rays = _ray_grid()
    a = np.asarray(JW.rays_to_root_frame(jctx, jnp.asarray(rays)))
    b = TW.rays_to_root_frame(tctx, torch.from_numpy(rays)).numpy()
    np.testing.assert_allclose(b, a, atol=1e-5)

    cfg, jsys, params_for, nj = _flagship_system(tiny=True)
    bp = {k: np.asarray(v) for k, v in params_for(1, 1).items()}
    tmpl = {k: np.asarray(v) for k, v in params_for(2, 1).items()}
    P = turntable_rotation(5, 64, angle_deg=10.0)
    np.testing.assert_array_equal(P, j_turn(5, 64, angle_deg=10.0))
    jm, jf = JR(jsys)._maybe_hit_fn(
        {k: jnp.asarray(v) for k, v in bp.items()},
        {k: jnp.asarray(v) for k, v in tmpl.items()}, jnp.asarray(rays),
        jnp.asarray(P))
    tsys = AnimNeRFSystem(cfg, t_make(128, nj, seed=0), device="cpu")
    tm, tf = TR(tsys, device="cpu")._maybe_hit_fn(bp, tmpl, rays, P)
    assert 0 < int(np.asarray(jm).sum()) < rays.shape[1]
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5)


def test_warp_blend_plain_matches_kernel():
    jctx, _ = _frame()
    jv, jt = JW._morton_inputs(jctx)
    rng = np.random.default_rng(8)
    verts = np.asarray(jctx.verts)
    N = 700
    pts = (verts[:, rng.integers(0, V, N)]
           + rng.normal(scale=0.06, size=(1, N, 3))).astype(np.float32)
    d, i = knn_pallas(jnp.asarray(pts), jv, k=4, packed=True,
                      transposed_out=True, interpret=True)
    rows = np.zeros((1, 8, N), np.float32)
    rows[0, :3] = pts[0].T
    # coarsen the LBS columns so that neighbours often share weights and
    # the confidence gate opens as well as closes
    jt = jt.at[..., :J].set(jnp.round(jt[..., :J] * 2.0) / 2.0)
    ja = warp_blend_fwd_pallas(jnp.asarray(rows), None, d, i, jt, J, 0.1,
                               0.9, interpret=True, tile_n=256,
                               inputs_t=True, xyz_rows=True)
    ta = warp_blend_fwd(torch.from_numpy(rows), torch.tensor(np.asarray(d)),
                        torch.tensor(np.asarray(i)),
                        torch.tensor(np.asarray(jt)), J, 0.1, 0.9)
    for name, a, b in zip(("out", "w", "bf"), ja, ta):
        # f32 gather, gate, blend and 4x4 apply: rounding only
        np.testing.assert_allclose(b.numpy(), np.asarray(a)[..., :N],
                                   atol=1e-5, err_msg=name)
    # both gate outcomes occur, so the gate is exercised
    w = ta[1].numpy()
    assert (w == 0).any() and (w[:, 1:] > 0).any()


def test_warp_blend_takes_the_top4_only():
    """The warp-blend takes the kNN's neighbour rows (k_neigh, any k >= 1),
    with distances and indices of one k; other shapes raise."""
    N = 10
    rows = torch.zeros(1, 8, N)
    table = torch.zeros(1, V, J + 16)
    for kd, ki in ((0, 0), (17, 16), (4, 5)):
        with pytest.raises(ValueError, match="shapes"):
            warp_blend_fwd(rows, torch.zeros(1, kd, N),
                           torch.zeros(1, ki, N, dtype=torch.int32), table, J,
                           0.1, 0.9)
    for k in (1, 16, 17, 40):
        _, w, _ = warp_blend_fwd(rows, torch.zeros(1, k, N),
                                 torch.zeros(1, k, N, dtype=torch.int32),
                                 table, J, 0.1, 0.9)
        assert w.shape == (1, k, N)


def test_unpose_matches_jax_warp():
    """Port unpose (kNN + warp-blend) against the JAX unpose on the same
    geometry, with its fused path forced through interpret mode."""
    from animnerf_tpu.utils.interpret import rows_interpret_forced

    jctx, tctx = _frame()
    rng = np.random.default_rng(9)
    N = 400
    pts = (np.asarray(jctx.verts)[:, rng.integers(0, V, N)]
           + rng.normal(scale=0.1, size=(1, N, 3))).astype(np.float32)
    with rows_interpret_forced():
        jc, _, jvalid = JW.unpose(jctx, jnp.asarray(pts))
        jc, jvalid = np.asarray(jc), np.asarray(jvalid)
    jax.clear_caches()
    tc, _, tvalid = TW.unpose(tctx, torch.from_numpy(pts))
    assert 0 < jvalid.sum() < N
    np.testing.assert_array_equal(tvalid.numpy(), jvalid)
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-4)


# ------------------------------------------------------------- backward


def _scatter_inputs(seed, B, N, V, clustered):
    rng = np.random.default_rng(seed)
    if clustered:  # Morton-coherent neighbours, as tests/test_blend.py:36
        idx = rng.integers(100, 140, size=(B, 4, N)).astype(np.int32)
        idx[..., ::31] = rng.integers(V - 20, V, size=idx[..., ::31].shape)
    else:
        idx = rng.integers(0, V, size=(B, 4, N)).astype(np.int32)
    w = rng.uniform(size=(B, 4, N)).astype(np.float32)
    g = rng.normal(size=(B, 16, N)).astype(np.float32)
    return idx, w, g


@pytest.mark.parametrize("clustered", [False, True])
def test_weighted_scatter_plain_matches_kernel(clustered):
    """weighted_scatter_rows_plain against the TPU scatter kernel in
    interpret mode (kNN-native idx/w, rows-native g): f32 sums in another
    order, rtol/atol 1e-5."""
    from animnerf_tpu.ops.blend import weighted_scatter_rows_pallas
    from animnerf_tpu_torch.ops.blend import (
        weighted_scatter_rows,
        weighted_scatter_rows_plain,
    )

    B, N, V = 2, 300, 1024
    idx, w, g = _scatter_inputs(3 + clustered, B, N, V, clustered)
    ref = np.asarray(weighted_scatter_rows_pallas(
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(g), V, tile_n=128,
        tile_v=256, interpret=True, transposed_in=True, g_t=True))
    got = weighted_scatter_rows_plain(*(torch.from_numpy(a)
                                        for a in (idx, w, g)), V)
    assert got.shape == (B, V, 16)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    # the wrapper takes the plain version on CPU tensors
    again = weighted_scatter_rows(*(torch.from_numpy(a)
                                    for a in (idx, w, g)), V)
    assert torch.equal(again, got)


@pytest.mark.parametrize("K", [2, 4, 8])
def test_weighted_scatter_sums_in_sorted_entry_order(K):
    """The plain scatter (the CUDA kernel's summation order) is bit-equal
    to a numpy loop over the entries e = (b * K + k) * N + n stably sorted
    by b * V + idx, adding the f32 product w * g to its row (zero weights
    and all-zero cotangent columns included); and within rtol/atol 1e-5 of
    the TPU scatter kernel in interpret mode."""
    from animnerf_tpu.ops.blend import weighted_scatter_rows_pallas
    from animnerf_tpu_torch.ops.blend import weighted_scatter_rows_plain

    B, N, V = 2, 160, 96
    rng = np.random.default_rng(20 + K)
    idx = rng.integers(0, V, size=(B, K, N)).astype(np.int32)
    idx[:, :, ::3] = rng.integers(40, 44, size=idx[:, :, ::3].shape)
    w = rng.uniform(size=(B, K, N)).astype(np.float32)
    g = rng.normal(size=(B, 16, N)).astype(np.float32)
    # gated-off neighbours and padded points: the scatter leaves these
    # entries out, the loop below adds their exact zeros
    w[:, 1:, ::2] = 0.0
    g[:, :, ::5] = 0.0

    keys = (idx + (np.arange(B) * V)[:, None, None]).reshape(-1)
    want = np.zeros((B * V, 16), np.float32)
    for e in np.argsort(keys, kind="stable"):
        b, n = e // (K * N), e % N
        want[keys[e]] = want[keys[e]] + w.reshape(-1)[e] * g[b, :, n]
    got = weighted_scatter_rows_plain(
        *(torch.from_numpy(a) for a in (idx, w, g)), V)
    np.testing.assert_array_equal(got.reshape(B * V, 16).numpy(), want)

    ref = np.asarray(weighted_scatter_rows_pallas(
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(g), V, tile_n=128,
        tile_v=128, interpret=True, transposed_in=True, g_t=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_warp_blend_rows_grads_match_jax_vjp():
    """The port's warp_blend_rows autograd Function (backward: the weighted
    scatter into the transform columns, R^T d_cano for the rows) against
    the JAX custom VJP of warp_blend_rows, its forward in interpret mode:
    f32 rounding only (atol 1e-5)."""
    from animnerf_tpu.ops.warp_blend import warp_blend_rows as j_wbr
    from animnerf_tpu.utils.interpret import rows_interpret_forced
    from animnerf_tpu_torch.ops.warp_blend import warp_blend_rows

    jctx, _ = _frame()
    jv, jt = JW._morton_inputs(jctx)
    jt = jt.at[..., :J].set(jnp.round(jt[..., :J] * 2.0) / 2.0)
    rng = np.random.default_rng(10)
    N = 500
    pts = (np.asarray(jctx.verts)[:, rng.integers(0, V, N)]
           + rng.normal(scale=0.06, size=(1, N, 3))).astype(np.float32)
    d, i = knn_pallas(jnp.asarray(pts), jv, k=4, packed=True,
                      transposed_out=True, interpret=True)
    rows = np.zeros((1, 8, N), np.float32)
    rows[0, :3] = pts[0].T
    ct = rng.normal(size=(1, 8, N)).astype(np.float32)

    with rows_interpret_forced():
        def f(x, t):
            return jnp.sum(j_wbr(x, d, i, t, J, 0.1, 0.9) * ct)

        jgx, jgt = jax.grad(f, argnums=(0, 1))(jnp.asarray(rows), jt)
    jax.clear_caches()
    x = torch.from_numpy(rows).requires_grad_()
    t = torch.tensor(np.asarray(jt)).requires_grad_()
    out = warp_blend_rows(x, torch.tensor(np.asarray(d)),
                          torch.tensor(np.asarray(i)), t, J, 0.1, 0.9)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), atol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgt), atol=1e-5)
    assert np.abs(t.grad.numpy()[..., J:]).max() > 0
    np.testing.assert_array_equal(t.grad.numpy()[..., :J], 0.0)


def test_unpose_rows_matches_jax():
    """Rows-native unpose (kNN on the Morton cloud, with the tile skip
    requested, then the warp-blend) against the JAX unpose_rows with its
    kernels in interpret mode."""
    from animnerf_tpu.utils.interpret import rows_interpret_forced

    jctx, tctx = _frame()
    rng = np.random.default_rng(12)
    N = 400
    pts = (np.asarray(jctx.verts)[:, rng.integers(0, V, N)]
           + rng.normal(scale=0.1, size=(1, N, 3))).astype(np.float32)
    rows = np.zeros((1, 8, N), np.float32)
    rows[0, :3] = pts[0].T
    with rows_interpret_forced():
        ref = np.asarray(JW.unpose_rows(jctx, jnp.asarray(rows)))
    jax.clear_caches()
    got = TW.unpose_rows(tctx, torch.from_numpy(rows), tile_skip=True)
    valid = ref[0, 3] < 0.2
    assert 0 < valid.sum() < N
    np.testing.assert_array_equal(got[0, 3].numpy() < 0.2, valid)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
