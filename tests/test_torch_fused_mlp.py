"""The port's NeRF parameter conversion and fused MLP forward (plain
version) against the JAX package: flax ``NeRFMLP.init`` params, the
scale512 checkpoint's npz keys, and ``fused_nerf_fwd`` in interpret mode."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animnerf_tpu.models.nerf import NeRFMLP as FlaxNeRF
from animnerf_tpu.ops import fused_mlp as JF
from animnerf_tpu_torch.models.nerf import NeRFMLP
from animnerf_tpu_torch.ops import fused_mlp as TF
from animnerf_tpu_torch.utils.convert import nerf_params_from_flax

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "docs", "demo",
                    "scale512", "ckpt")


def _flax(dtype=jnp.float32, seed=0):
    mod = FlaxNeRF(freqs_xyz=10, freqs_dir=0, use_view=False,
                   compute_dtype=dtype)
    params = mod.init(jax.random.PRNGKey(seed), jnp.zeros((2, 3)))
    return mod, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_pack_params_matches_jax(name):
    _, params = _flax()
    jw, jb = JF.pack_params(params, 10, dtype=jnp.dtype(name))
    tw, tb = TF.pack_params(nerf_params_from_flax(params), 10, name)
    for a, b in zip(jw + jb, tw + tb):
        assert a.shape == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.to(torch.float32).numpy())


def test_convert_accepts_checkpoint_npz_keys():
    with np.load(os.path.join(CKPT, "anim_nerf.npz")) as data:
        flat = {k: data[k] for k in data.files}
    for net in ("nerf", "nerf_fine"):
        sd = nerf_params_from_flax({k: v for k, v in flat.items()
                                    if k.startswith(net + "/")})
        m = NeRFMLP(10)
        m.load_state_dict(sd)  # names and shapes line up
        np.testing.assert_array_equal(
            m.xyz_4.weight.detach().numpy(),
            flat[f"{net}/params/xyz_4/kernel"].T)
    with pytest.raises(ValueError, match="twice"):
        nerf_params_from_flax(flat)  # two networks at once


def _rows(M=700, seed=0):
    xyz = np.random.default_rng(seed).normal(scale=0.5, size=(M, 3))
    rows = np.zeros((1, 8, M), np.float32)
    rows[0, :3] = xyz.T
    return rows


def _jax_fused(params, rows, dtype):
    ws, bs = JF.pack_params(params, 10, dtype=dtype)
    M = rows.shape[-1]
    pad = (-M) % 256
    x = jnp.pad(jnp.asarray(rows), ((0, 0), (0, 0), (0, pad)))
    if dtype == jnp.float32:
        out = JF.fused_nerf_fwd(x, ws, bs, n_freqs=10, tile=256, dtype=dtype,
                                interpret=True)
    else:
        # XLA:CPU compiles no bf16 x bf16 -> f32 dot; run the interpreted
        # kernel eagerly, as the JAX package's own bf16 test does
        with jax.disable_jit():
            out = JF.fused_nerf_fwd(x, ws, bs, n_freqs=10, tile=256,
                                    dtype=dtype, interpret=True)
    return np.asarray(out)[..., :M]


def test_fused_forward_f32_matches_kernel():
    _, params = _flax()
    rows = _rows()
    ref = _jax_fused(params, rows, jnp.float32)
    ws, bs = TF.pack_params(nerf_params_from_flax(params), 10, "float32")
    out = TF.fused_nerf_fwd(torch.from_numpy(rows), ws, bs, 10,
                            "float32").numpy()
    # f32 throughout; only the dot's summation order differs (the same
    # bounds as tests/test_fused_mlp.py)
    np.testing.assert_allclose(out[0, 0:3], ref[0, 0:3], atol=1e-5)
    np.testing.assert_allclose(out[0, 3], ref[0, 3], atol=1e-4)
    np.testing.assert_array_equal(out[0, 4:], 0.0)


def test_fused_forward_bf16_matches_kernel():
    _, params = _flax()
    rows = _rows(300)
    ref = _jax_fused(params, rows, jnp.bfloat16)
    ws, bs = TF.pack_params(nerf_params_from_flax(params), 10, "bfloat16")
    out = TF.fused_nerf_fwd(torch.from_numpy(rows), ws, bs, 10,
                            "bfloat16").numpy()
    # same rounding points; the f32 accumulation order differs, which can
    # flip a bf16 rounding between layers (bounds of tests/test_fused_mlp.py)
    np.testing.assert_allclose(out[0, 0:3], ref[0, 0:3], atol=2e-2)
    np.testing.assert_allclose(out[0, 3], ref[0, 3], atol=3e-2, rtol=2e-2)


def test_module_packs_once_until_reloaded_or_moved():
    _, p0 = _flax(seed=0)
    _, p1 = _flax(seed=1)
    m = NeRFMLP(10, "float32")
    m.load_state_dict(nerf_params_from_flax(p0))
    first = m.packed()
    assert m.packed() is first  # cached across forwards
    m.load_state_dict(nerf_params_from_flax(p1))
    ws, bs = m.packed()
    assert ws is not first[0]
    want_w, want_b = TF.pack_params(nerf_params_from_flax(p1), 10, "float32")
    for a, b in zip(ws + bs, want_w + want_b):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    again = m.packed()
    m.to("cpu")
    assert m.packed() is not again  # a move repacks on its device


def test_module_forward_matches_flax_apply():
    mod, params = _flax()
    xyz = _rows(200)[0, :3].T.copy()
    rgb_j, sig_j = mod.apply(params, jnp.asarray(xyz))
    m = NeRFMLP(10, "float32")
    m.load_state_dict(nerf_params_from_flax(params))
    rgb, sig = m(torch.from_numpy(xyz)[None])
    np.testing.assert_allclose(rgb[0].detach().numpy(), np.asarray(rgb_j),
                               atol=1e-5)
    np.testing.assert_allclose(sig[0].detach().numpy(), np.asarray(sig_j),
                               atol=1e-4)
