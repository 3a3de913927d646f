"""The fused MLP backward at every encoding the fused field takes
(n_freqs 0..20, ``models/anim_nerf.py::use_fused_mlp``): the plain
backward against the TPU kernel's ``fused_nerf_bwd`` in interpret mode
at n_freqs 4, 8, 12 and 20, and the backward's two-width layout
(``bwd_layout``: the scratch's encoding array 64 or 128 columns wide,
the weight gradients of layers 0 and 8 enc_rows wide) with its weight
gradients against numpy in f64 at each n_freqs."""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_fused_mlp import _dout, _rel_l2, _rows  # noqa: E402

from animnerf_tpu.models.nerf import NeRFMLP as FlaxNeRF  # noqa: E402
from animnerf_tpu.ops import fused_mlp as JF  # noqa: E402
from animnerf_tpu_torch.ops import fused_mlp as TF  # noqa: E402
from animnerf_tpu_torch.utils.convert import nerf_params_from_flax  # noqa: E402

torch.set_num_threads(1)

# the 10-frequency case's tolerances (tests/test_torch_fused_mlp.py
# test_fused_backward_matches_kernel): f32 summation order only; bf16 the
# same rounding points, with flips of bf16 roundings between layers
TOLS = {"float32": 1e-5, "bfloat16": 2e-2}


def _params(n_freqs, seed=0):
    mod = FlaxNeRF(freqs_xyz=n_freqs, freqs_dir=0, use_view=False,
                   compute_dtype=jnp.float32)
    params = mod.init(jax.random.PRNGKey(seed), jnp.zeros((2, 3)))
    return jax.tree.map(np.asarray, params)


def _jax_bwd(params, rows, dout, n_freqs, dtype):
    ws, bs = JF.pack_params(params, n_freqs, dtype=dtype)
    M = rows.shape[-1]
    pad = ((0, 0), (0, 0), (0, (-M) % 256))
    x, d = jnp.pad(jnp.asarray(rows), pad), jnp.pad(jnp.asarray(dout), pad)
    if dtype == jnp.float32:
        out = JF.fused_nerf_bwd(x, ws, bs, d, n_freqs=n_freqs, tile=256,
                                dtype=dtype, interpret=True)
    else:
        # XLA:CPU compiles no bf16 x bf16 -> f32 dot: run it eagerly
        with jax.disable_jit():
            out = JF.fused_nerf_bwd(x, ws, bs, d, n_freqs=n_freqs, tile=256,
                                    dtype=dtype, interpret=True)
    d_xyz, d_ws, d_bs = jax.tree.map(np.asarray, out)
    return d_xyz[..., :M], d_ws, d_bs


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_freqs", [4, 8, 12, 20])
def test_backward_matches_kernel_at_n_freqs(n_freqs, name):
    """fused_nerf_bwd_plain against the TPU kernel in interpret mode at an
    encoding of enc_rows(n_freqs) rows (32, 56, 80, 128): d_xyz and every
    weight and bias gradient, in pack_params' shapes, within the
    10-frequency case's rel-L2 bounds, on 512 points (in bf16 a flipped
    rounding moves a weight-gradient sum by about its point's share: at
    200 points n_freqs 12 reaches 2.4e-2, at 512 every case stays below
    1.2e-2)."""
    M = 512
    params = _params(n_freqs)
    rows = _rows(M)
    dout = _dout(M)
    ref = _jax_bwd(params, rows, dout, n_freqs, jnp.dtype(name))
    ws, bs = TF.pack_params(nerf_params_from_flax(params), n_freqs, name)
    out = TF.fused_nerf_bwd(torch.from_numpy(rows), ws, bs,
                            torch.from_numpy(dout), n_freqs, name)
    tol = TOLS[name]
    assert _rel_l2(out[0].numpy(), ref[0]) < tol, "d_xyz"
    np.testing.assert_array_equal(out[0][0, 3:].numpy(), 0.0)
    E = TF.enc_rows(n_freqs)
    assert out[1][0].shape == out[1][8].shape == (256, E)
    for i, (a, b) in enumerate(zip(out[1] + out[2], ref[1] + ref[2])):
        assert a.shape == b.shape
        if np.abs(b).max() == 0:  # padded rows, the skip half's bias
            np.testing.assert_array_equal(a.numpy(), 0.0)
        else:
            assert _rel_l2(a.numpy(), b) < tol, f"gradient {i}"


def _np_wgrad(scratch, heads, rows, chunk, ec, er, bf16):
    """The weight-gradient pass restated in numpy f64 for a scratch whose
    encoding array is ec wide and weights with er encoding rows: the flat
    gradients dW_0..12, db_0..12 (pack_params' shapes), padded to 64."""
    hw = [ec] + [256] * 9 + [128]
    gw = [256] * 9 + [128]
    hc = np.cumsum([0] + hw)
    gc = sum(hw) + np.cumsum([0] + gw)
    sc = np.asarray(scratch, np.float64)
    H = [sc[hc[h] * chunk:hc[h + 1] * chunk].reshape(chunk, hw[h])[:rows]
         for h in range(11)]
    G = [sc[gc[g] * chunk:gc[g + 1] * chunk].reshape(chunk, gw[g])[:rows]
         for g in range(10)]
    H[0] = H[0][:, :er]
    hd = np.asarray(heads, np.float64).reshape(-1)[:chunk * 4].reshape(
        chunk, 4)[:rows]
    hb = (np.asarray(np.asarray(hd, np.float32).astype(jnp.bfloat16),
                     np.float64) if bf16 else hd)
    dw = [G[g].T @ H[h] for g, h in
          [(0, 0), (1, 1), (2, 2), (3, 3), (4, 4), (5, 5), (6, 6), (7, 7),
           (4, 0)]]
    dw9 = np.zeros((8, 256))
    dw9[0] = hb[:, 3] @ H[8]
    dw12 = np.zeros((8, 128))
    dw12[:3] = hb[:, :3].T @ H[10]
    dw += [dw9, G[8].T @ H[8], G[9].T @ H[9], dw12]
    db = [G[g].sum(0) for g in range(8)] + [np.zeros(256)]
    db9 = np.zeros(8)
    db9[0] = hd[:, 3].sum()
    db12 = np.zeros(8)
    db12[:3] = hd[:, :3].sum(0)
    db += [db9, G[8].sum(0), G[9].sum(0), db12]
    flat = np.concatenate([t.ravel() for t in dw + db])
    return np.pad(flat, (0, (-flat.size) % 64))


@pytest.mark.parametrize("n_freqs", range(TF.MAX_BWD_FREQS + 1))
def test_bwd_layout_and_wgrad_at_n_freqs(n_freqs):
    """bwd_layout(n) for every n the fused field takes: enc_rows(n) rows
    (dW_0, dW_8 columns) and enc_cols(n) columns (64 up to 10, 128 above);
    bwd_scratch_plain writes the encoding array that wide, zero from
    3 + 6 n, and wgrad_from_scratch_plain on that layout (f64) equals the
    numpy f64 restatement over a chunk padded to 128 points."""
    lay = TF.bwd_layout(n_freqs)
    assert lay.rows == TF.enc_rows(n_freqs)
    assert lay.cols == (64 if n_freqs <= 10 else 128) == TF.enc_cols(n_freqs)
    name = "bfloat16" if n_freqs % 2 else "float32"
    M, chunk = 150, 256
    mlp = TF.pack_params(_state(n_freqs), n_freqs, name)
    pad = ((0, 0), (0, 0), (0, chunk - M))
    _, scratch, heads = TF.bwd_scratch_plain(
        torch.from_numpy(np.pad(_rows(M, seed=n_freqs), pad)), *mlp,
        torch.from_numpy(np.pad(_dout(M), pad)), n_freqs, name)
    assert scratch.numel() == chunk * (lay.cols + 2 * (9 * 256 + 128))
    H, _ = TF.scratch_views(scratch, chunk, lay.cols)
    assert torch.count_nonzero(H[0][:, 3 + 6 * n_freqs:]) == 0
    got = TF.wgrad_from_scratch_plain(scratch, heads, M, chunk,
                                      torch.float64, n_freqs=n_freqs)
    want = _np_wgrad(scratch.float().numpy(), heads.numpy(), M, chunk,
                     lay.cols, lay.rows, name == "bfloat16")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)
    d_ws, _ = TF._split_grads(got.float(), *mlp)
    assert d_ws[0].shape == d_ws[8].shape == (256, lay.rows)


def _state(n_freqs, seed=0):
    from animnerf_tpu_torch.models.nerf import NeRFMLP

    mlp = NeRFMLP(n_freqs, "float32",
                  generator=torch.Generator().manual_seed(seed))
    return {k: v.detach() for k, v in mlp.state_dict().items()}


def test_bwd_layout_range():
    """bwd_layout raises past the fused field's encodings, and a scratch
    of the wrong width is refused by the plain weight-gradient pass."""
    for n in (-1, TF.MAX_BWD_FREQS + 1):
        with pytest.raises(ValueError, match="n_freqs"):
            TF.bwd_layout(n)
    assert 3 + 6 * TF.MAX_BWD_FREQS <= 128 < 3 + 6 * (TF.MAX_BWD_FREQS + 1)
    chunk = 128
    scratch = torch.zeros(chunk * (64 + 2 * (9 * 256 + 128)))
    heads = torch.zeros(chunk * 4)
    with pytest.raises(ValueError, match="wide"):
        TF.wgrad_from_scratch_plain(scratch, heads, 1, chunk, n_freqs=12)
