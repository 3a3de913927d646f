"""The designs of the weighted scatter (kernel 5) and the warp-blend
(kernel 2) CUDA kernels, on the CPU: the scatter's radix placement
(modelled by ``scatter_order_plain``) gives the stable order the plain
version sums in, and its row bounds; the warp-blend's padded rows keep the
table's values where the kernel reads them; its residual-free mode
returns the full mode's ``out``, and ``warp_blend_rows`` takes it exactly
when no gradient is needed, the gradients still matching the JAX VJP."""

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
from animnerf_tpu_torch.ops import blend, warp_blend
from animnerf_tpu_torch.ops.blend import (
    radix_passes,
    scatter_order_plain,
    scatter_workspace_words,
    sort_entries,
)
from animnerf_tpu_torch.ops.warp_blend import (
    pad_table_plain,
    warp_blend_fwd,
    warp_blend_row_layout,
    warp_blend_rows,
)

torch.set_num_threads(1)

# the five families' LBS widths: FLAME, MANO, SMPL, SMPL-H, SMPL-X
FAMILY_LBS = (5, 16, 24, 52, 55)


def _entries(dist: str, K: int, B: int, N: int, V: int, seed: int):
    """idx, w, g as the warp-blend backward gets them, with zero weights
    and zero cotangent columns; ``dist`` shapes the rows: uniform,
    clustered (one row holding half of the entries), empty_rows (every
    index in 8 rows of a frame) or all_dead (every weight zero)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, V, size=(B, K, N)).astype(np.int32)
    w = rng.uniform(size=(B, K, N)).astype(np.float32)
    g = rng.normal(size=(B, 16, N)).astype(np.float32)
    w[:, K // 2:, ::3] = 0.0
    g[:, :, ::7] = 0.0
    if dist == "clustered":
        flat = idx.reshape(-1)
        flat[rng.permutation(flat.size)[:flat.size // 2]] = V // 3
    elif dist == "empty_rows":
        idx = rng.integers(V // 2, V // 2 + 8, size=idx.shape).astype(
            np.int32)
    elif dist == "all_dead":
        w[:] = 0.0
    return (torch.from_numpy(a) for a in (idx, w, g))


@pytest.mark.parametrize("dist", ["uniform", "clustered", "empty_rows",
                                  "all_dead"])
@pytest.mark.parametrize("K", [1, 4, 8, 16])
def test_radix_placement_gives_the_stable_sort_order(K, dist):
    """The kernel's placement (LSD passes over 9-bit digits: digit base +
    tile offset + earlier rounds + earlier warps + earlier lanes) puts the
    live entries in the order torch.sort(stable=True) gives the keys of
    sort_entries, dead entries left out, and bounds each row's segment
    there (0, 0 for an empty row), with one, two and three passes."""
    B, N = 2, 700
    for V in (200, 6890, 140000):  # B V: 400, 13,780, 280,000
        idx, w, g = _entries(dist, K, B, N, V, seed=K + len(dist) + V)
        keys, perm = sort_entries(idx, w, g, V)
        live = keys < B * V
        L = int(live.sum())
        # the prep kernel's keys: b V + idx, -1 for a dead entry
        raw = (idx + (torch.arange(B, dtype=torch.int32) * V)[:, None, None])
        alive = (w != 0) & (g != 0).any(1, keepdim=True)
        raw = torch.where(alive, raw, -1).reshape(-1)
        order, begin, end = scatter_order_plain(raw, B * V)
        assert radix_passes(B * V) == {200: 1, 6890: 2, 140000: 3}[V]
        assert torch.equal(order, perm[:L])
        counts = torch.bincount(keys[live].long(), minlength=B * V)
        assert torch.equal(end - begin, counts)
        starts = torch.cumsum(counts, 0) - counts
        assert torch.equal(begin[counts > 0], starts[counts > 0])
        assert not begin[counts == 0].any()
        if dist == "all_dead":
            assert L == 0


def test_scatter_workspace_covers_every_region():
    """The scratch the wrapper allocates covers the kernel's regions
    (csrc/scatter.cu make_plan), each rounded up to 16 bytes."""
    for B, k, N, V in ((16, 4, 32768, 6890), (16, 8, 33757, 6890),
                       (1, 1, 1, 1), (40, 16, 3001, 6890)):
        M = B * k * N
        tiles = -(-M // blend.TILE)
        need = (M + 2 * M + 4 * M + 16 * B * N + blend.RADIX * tiles
                + blend.RADIX * radix_passes(B * V) + 1 + 2 * B * V)
        words = scatter_workspace_words(B, k, N, V)
        assert words % 4 == 0 and need <= words < need + 4 * 8


@pytest.mark.parametrize("num_lbs", FAMILY_LBS)
def test_padded_rows_keep_the_table_where_the_kernel_reads(num_lbs):
    """The kernel reads rows of Lp + 16 floats, Lp = num_lbs rounded up to
    4: the LBS part at 0, zeros after it, the transform part at Lp, every
    row and both parts on 16 bytes; a table whose LBS part is already a
    multiple of 4 is that layout as it is."""
    Lp = warp_blend_row_layout(num_lbs)
    assert Lp % 4 == 0 and num_lbs <= Lp < num_lbs + 4
    rng = np.random.default_rng(num_lbs)
    t = torch.from_numpy(rng.normal(size=(2, 33, num_lbs + 16))
                         .astype(np.float32))
    p = pad_table_plain(t, num_lbs)
    assert p.shape == (2, 33, Lp + 16)
    assert torch.equal(p[..., :num_lbs], t[..., :num_lbs])
    assert not p[..., num_lbs:Lp].any()
    assert torch.equal(p[..., Lp:], t[..., num_lbs:])
    if Lp == num_lbs:
        assert torch.equal(p, t)


def _warp_inputs(num_lbs: int, K: int, seed: int):
    """Points, kNN-shaped distances and indices, and a table with one-hot
    LBS columns on three bones (so that several neighbours blend)."""
    rng = np.random.default_rng(seed)
    V, N = 60, 257
    table = rng.normal(size=(1, V, num_lbs + 16)).astype(np.float32)
    table[0, :, :num_lbs] = np.eye(num_lbs, dtype=np.float32)[
        rng.integers(0, min(num_lbs, 3), V)]
    d = np.sort(rng.uniform(size=(1, K, N)), axis=1).astype(np.float32)
    idx = rng.integers(0, V, size=(1, K, N)).astype(np.int32)
    rows = np.zeros((1, 8, N), np.float32)
    rows[0, :3] = rng.normal(size=(3, N))
    return tuple(torch.from_numpy(a) for a in (rows, d, idx, table))


@pytest.mark.parametrize("num_lbs", FAMILY_LBS)
def test_residual_free_mode_returns_the_same_out(num_lbs):
    """On CPU tensors warp_blend_fwd(residuals=False) returns the full
    mode's out bit for bit, and no w or bf."""
    for K in (1, 4, 8):
        args = _warp_inputs(num_lbs, K, seed=num_lbs + K) + (num_lbs, 0.1,
                                                               0.9)
        out, w, bf = warp_blend_fwd(*args)
        o, w0, bf0 = warp_blend_fwd(*args, residuals=False)
        assert w0 is None and bf0 is None
        assert w.shape == (1, K, 257) and bf.shape == (1, 16, 257)
        assert torch.equal(o, out)
        # several neighbours blend on the one-hot columns
        if K > 1:
            assert (w[0, 1:] > 0).any()


def _record_residuals(monkeypatch) -> list:
    seen, orig = [], warp_blend.warp_blend_fwd

    def record(*args, residuals=True, **kw):
        seen.append(residuals)
        return orig(*args, residuals=residuals, **kw)

    monkeypatch.setattr(warp_blend, "warp_blend_fwd", record)
    return seen


def test_warp_blend_rows_no_grad_takes_the_residual_free_mode(monkeypatch):
    """Without a gradient to keep (no_grad, or inputs that need none)
    warp_blend_rows writes no residuals, and its out is the full mode's."""
    seen = _record_residuals(monkeypatch)
    rows, d, idx, table = _warp_inputs(24, 4, seed=3)
    full = warp_blend.warp_blend_fwd(rows, d, idx, table, 24, 0.1, 0.9)[0]
    with torch.no_grad():
        a = warp_blend_rows(rows.requires_grad_(), d, idx,
                            table.requires_grad_(), 24, 0.1, 0.9)
    b = warp_blend_rows(rows.detach(), d, idx, table.detach(), 24, 0.1, 0.9)
    assert seen == [True, False, False]
    assert torch.equal(a, full) and torch.equal(b, full)


def test_warp_blend_rows_grad_keeps_residuals_and_matches_jax_vjp(
        monkeypatch):
    """Under grad warp_blend_rows runs the full mode, and its gradients
    (the weighted scatter into the transform columns, R^T d_cano for the
    rows) match the JAX custom VJP of warp_blend_rows with its forward in
    interpret mode: f32 rounding only (atol 1e-5)."""
    from animnerf_tpu.ops.warp_blend import warp_blend_rows as j_wbr
    from animnerf_tpu.utils.interpret import rows_interpret_forced

    V, J = 256, 24
    bp = random_pose_params(J, batch=1, seed=11)
    tmpl = random_pose_params(J, batch=1, seed=12)
    tmpl["transl"] = np.zeros_like(tmpl["transl"])
    jctx = JW.prepare_frame(j_make(V, J, seed=6),
                            {k: jnp.asarray(v) for k, v in bp.items()},
                            {k: jnp.asarray(v) for k, v in tmpl.items()})
    jv, jt = JW._morton_inputs(jctx)
    jt = jt.at[..., :J].set(jnp.round(jt[..., :J] * 2.0) / 2.0)
    rng = np.random.default_rng(21)
    N = 300
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

    seen = _record_residuals(monkeypatch)
    x = torch.from_numpy(rows).requires_grad_()
    t = torch.tensor(np.asarray(jt)).requires_grad_()
    out = warp_blend_rows(x, torch.tensor(np.asarray(d)),
                          torch.tensor(np.asarray(i)), t, J, 0.1, 0.9)
    (out * torch.from_numpy(ct)).sum().backward()
    assert seen == [True]
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), atol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgt), atol=1e-5)
    assert np.abs(t.grad.numpy()[..., J:]).max() > 0
