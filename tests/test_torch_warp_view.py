"""Kernel 2's ``warp_view`` option and its point layout against the JAX
package on the CPU.

The plain version of the warp-blend with ``warp_view`` (view direction
rows 4:7 warped by the blended 4x4, translation included) against the
TPU kernel ``warp_blend_fwd_pallas(..., warp_view=True, tile_n=256,
interpret=True)`` at K 1, 4, 8, an odd N and SMPL and SMPL-X row widths,
in the rows layout and in the point layout (``xyz_rows=False``, which
packs [x|y|z|0|vx|vy|vz|0] itself); the point-form autograd's d_xyz,
d_viewdir and d_table against ``jax.vjp`` of the JAX ``warp_blend`` with
its forward patched to interpret mode (as ``tests/test_warp_blend.py``
patches it), ``warp_view`` on and off (off passes the view direction's
cotangent through). Tolerances: f32 rounding only, atol 1e-5 for the
forward (the sums over k in the same order), atol/rtol 1e-4 for the
gradients (the scatter's sums in another order), as the JAX package's own
test holds its kernel against XLA.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animnerf_tpu_torch.ops import warp_blend as TW

torch.set_num_threads(1)

N = 257  # odd: not a whole number of the kernel's 256-point tiles


def _rig(K: int, J: int, seed: int, V: int = 300):
    """Ray-like points, view directions, their true K nearest vertices
    (numpy), and a [lbs | T] table whose LBS rows repeat in groups of 7,
    so that the confidence gate passes for some pairs and fails for
    others."""
    rng = np.random.default_rng(seed)
    verts = rng.normal(scale=0.4, size=(1, V, 3)).astype(np.float32)
    o = rng.normal(scale=1.0, size=(1, N // 50 + 1, 1, 3))
    d = rng.normal(size=o.shape)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.linspace(-1.2, 1.2, 50).reshape(1, 1, 50, 1)
    pts = (o + t * d).reshape(1, -1, 3)[:, :N].astype(np.float32)
    vd = np.broadcast_to(d, (1, o.shape[1], 50, 3)).reshape(1, -1, 3)[
        :, :N].astype(np.float32)
    d2 = np.sum((pts[:, :, None] - verts[:, None]) ** 2, axis=-1)
    idx = np.argsort(d2, axis=-1, kind="stable")[..., :K].astype(np.int32)
    dists = np.sqrt(np.take_along_axis(d2, idx, axis=-1)).astype(np.float32)
    lbs = rng.dirichlet(np.ones(J) * 0.2, size=V // 7 + 1).astype(np.float32)
    lbs = np.repeat(lbs, 7, axis=0)[:V]
    T = rng.normal(scale=0.3, size=(1, V, 16)).astype(np.float32)
    table = np.concatenate([lbs[None], T], axis=-1).astype(np.float32)
    return pts, vd, dists, idx, table


CASES = [(1, 24), (4, 24), (8, 24), (4, 55)]  # (K, num_lbs): SMPL, SMPL-X


def _jax_fwd(pts, vd, dists, idx, table, J, **kw):
    from animnerf_tpu.ops.warp_blend import warp_blend_fwd_pallas

    out = warp_blend_fwd_pallas(
        jnp.asarray(pts), None if vd is None else jnp.asarray(vd),
        jnp.asarray(dists), jnp.asarray(idx), jnp.asarray(table), J, 0.1,
        0.9, warp_view=True, tile_n=256, interpret=True, **kw)
    return [np.asarray(a)[..., :N] for a in out]


@pytest.mark.parametrize("K, J", CASES)
def test_plain_warp_view_matches_the_tpu_kernel(K, J):
    """The rows layout (xyz_rows=True, inputs_t=True): every output, the
    view rows warped, row 7 zero; the residual-free mode's out is the
    full mode's."""
    pts, vd, dists, idx, table = _rig(K, J, seed=10 * K + J)
    rows = np.zeros((1, 8, N), np.float32)
    rows[0, 0:3] = pts[0].T
    rows[0, 4:7] = vd[0].T
    d_t, i_t = dists.transpose(0, 2, 1), idx.transpose(0, 2, 1)
    want = _jax_fwd(rows, None, d_t, i_t, table, J, inputs_t=True,
                    xyz_rows=True)
    args = (torch.from_numpy(rows), torch.from_numpy(d_t.copy()),
            torch.from_numpy(i_t.copy()), torch.from_numpy(table), J, 0.1,
            0.9)
    got = TW.warp_blend_fwd(*args, warp_view=True)
    for name, a, b in zip(("out", "w", "bf"), want, got):
        np.testing.assert_allclose(b.numpy(), a, atol=1e-5, err_msg=name)
    out = got[0].numpy()
    assert np.abs(out[0, 4:7]).max() > 0 and not out[0, 7].any()
    # the view rows are warped with the translation: not R vd alone
    bf = got[2].numpy()[0].reshape(4, 4, N)
    rot_only = np.einsum("ijn,jn->in", bf[:3, :3], rows[0, 4:7])
    assert not np.allclose(out[0, 4:7], rot_only, atol=1e-3)
    o_only = TW.warp_blend_fwd(*args, residuals=False, warp_view=True)[0]
    assert torch.equal(o_only, got[0])
    # without warp_view the view rows stay zero and the rest is the same
    off = TW.warp_blend_fwd(*args)[0]
    assert not off[:, 4:].any()
    assert torch.equal(off[:, :4], got[0][:, :4])
    if K > 1:
        assert (got[1][0, 1:] > 0).any()


@pytest.mark.parametrize("K, J", CASES)
def test_point_layout_matches_the_tpu_kernel(K, J):
    """warp_blend (the point layout, (B, N, k) inputs) against the TPU
    kernel packing its own rows (xyz_rows=False): the canonical points,
    the warped view direction and the blended distance."""
    pts, vd, dists, idx, table = _rig(K, J, seed=10 * K + J + 1)
    out = _jax_fwd(pts, vd, dists, idx, table, J)[0]
    cano, vd_out, bd = TW.warp_blend(
        torch.from_numpy(pts), torch.from_numpy(vd),
        torch.from_numpy(dists), torch.from_numpy(idx),
        torch.from_numpy(table), J, 0.1, 0.9, warp_view=True)
    np.testing.assert_allclose(cano.numpy()[0].T, out[0, 0:3], atol=1e-5)
    np.testing.assert_allclose(bd.numpy()[0].T, out[0, 3:4], atol=1e-5)
    np.testing.assert_allclose(vd_out.numpy()[0].T, out[0, 4:7], atol=1e-5)


def _jax_vjp(pts, vd, dists, idx, table, J, warp_view, cts):
    """jax.vjp of the JAX warp_blend (its forward in interpret mode) at
    the cotangents (d_cano, d_vd) -> (d_xyz, d_viewdir, d_table)."""
    import animnerf_tpu.ops.warp_blend as WB

    orig = WB.warp_blend_fwd_pallas

    def patched(*a, **k):
        k.update(tile_n=256, interpret=True)
        return orig(*a, **k)

    WB.warp_blend_fwd_pallas = patched
    try:
        def f(x, v, t):
            c, vo, _ = WB.warp_blend(x, v, jnp.asarray(dists),
                                     jnp.asarray(idx), t, J, 0.1, 0.9,
                                     warp_view)
            return c, vo

        _, vjp = jax.vjp(f, jnp.asarray(pts), jnp.asarray(vd),
                         jnp.asarray(table))
        return [np.asarray(g) for g in vjp(tuple(jnp.asarray(c)
                                                 for c in cts))]
    finally:
        WB.warp_blend_fwd_pallas = orig
        jax.clear_caches()


@pytest.mark.parametrize("warp_view", [True, False])
@pytest.mark.parametrize("K, J", [(4, 24), (8, 55)])
def test_point_layout_gradients_match_jax_vjp(K, J, warp_view):
    """d_xyz, d_viewdir (R^T d_vd with warp_view, d_vd passed through
    without) and d_table (the view term added to d_bf before the weighted
    scatter) of the point-form autograd against the JAX custom VJP."""
    pts, vd, dists, idx, table = _rig(K, J, seed=100 + K + J)
    rng = np.random.default_rng(K + J)
    cts = [rng.normal(size=(1, N, 3)).astype(np.float32) for _ in range(2)]
    want = _jax_vjp(pts, vd, dists, idx, table, J, warp_view, cts)
    x = torch.from_numpy(pts).requires_grad_()
    v = torch.from_numpy(vd.copy()).requires_grad_()
    t = torch.from_numpy(table).requires_grad_()
    cano, vd_out, _ = TW.warp_blend(x, v, torch.from_numpy(dists),
                                    torch.from_numpy(idx), t, J, 0.1, 0.9,
                                    warp_view=warp_view)
    ((cano * torch.from_numpy(cts[0])).sum()
     + (vd_out * torch.from_numpy(cts[1])).sum()).backward()
    for name, a, b in zip(("d_xyz", "d_viewdir", "d_table"), want,
                          (x.grad, v.grad, t.grad)):
        np.testing.assert_allclose(b.numpy(), a, atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    assert np.abs(t.grad.numpy()[..., J:]).max() > 0
    if not warp_view:
        np.testing.assert_array_equal(v.grad.numpy(), cts[1])
