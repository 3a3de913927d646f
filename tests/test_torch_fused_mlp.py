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


# ------------------------------------------------------------- backward


def _dout(M, seed=2):
    d = np.zeros((1, 8, M), np.float32)
    d[0, :4] = np.random.default_rng(seed).normal(size=(4, M))
    return d


def _jax_bwd(params, rows, dout, dtype):
    ws, bs = JF.pack_params(params, 10, dtype=dtype)
    M = rows.shape[-1]
    pad = ((0, 0), (0, 0), (0, (-M) % 256))
    x, d = jnp.pad(jnp.asarray(rows), pad), jnp.pad(jnp.asarray(dout), pad)
    if dtype == jnp.float32:
        out = JF.fused_nerf_bwd(x, ws, bs, d, n_freqs=10, tile=256,
                                dtype=dtype, interpret=True)
    else:
        # XLA:CPU compiles no bf16 x bf16 -> f32 dot (see the forward test)
        with jax.disable_jit():
            out = JF.fused_nerf_bwd(x, ws, bs, d, n_freqs=10, tile=256,
                                    dtype=dtype, interpret=True)
    d_xyz, d_ws, d_bs = jax.tree.map(np.asarray, out)
    return d_xyz[..., :M], d_ws, d_bs


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()),
                                                 1e-30)


@pytest.mark.parametrize("name,M,tol", [("float32", 500, 1e-5),
                                        ("bfloat16", 200, 2e-2)])
def test_fused_backward_matches_kernel(name, M, tol):
    """fused_nerf_bwd_plain (the CUDA kernel's plain version) against the
    TPU kernel's fused_nerf_bwd in interpret mode: d_xyz, all 13 weight and
    13 bias gradients. f32: summation order only (rel-L2 1e-5). bf16: the
    same rounding points, but the f32 accumulation order differs and flips
    bf16 roundings of the cotangents between layers (rel-L2 2e-2)."""
    _, params = _flax()
    rows, dout = _rows(M), _dout(M)
    dt = jnp.dtype(name)
    ref = _jax_bwd(params, rows, dout, dt)
    ws, bs = TF.pack_params(nerf_params_from_flax(params), 10, name)
    out = TF.fused_nerf_bwd(torch.from_numpy(rows), ws, bs,
                            torch.from_numpy(dout), 10, name)
    assert _rel_l2(out[0].numpy(), ref[0]) < tol, "d_xyz"
    np.testing.assert_array_equal(out[0][0, 3:].numpy(), 0.0)
    for i, (a, b) in enumerate(zip(out[1] + out[2], ref[1] + ref[2])):
        assert a.shape == b.shape
        if np.abs(b).max() == 0:  # padded rows, the skip half's bias
            np.testing.assert_array_equal(a.numpy(), 0.0)
        else:
            assert _rel_l2(a.numpy(), b) < tol, f"gradient {i}"


def test_autograd_function_matches_autograd_of_plain_forward():
    """FusedNerf's backward (fused_nerf_bwd) against torch autograd through
    the plain forward, f32, from the module's live parameters: the plain
    backward is the same math written out (rel-L2 1e-5)."""
    torch.manual_seed(0)
    m = NeRFMLP(10, "float32")
    rows = torch.from_numpy(_rows(300)).requires_grad_()
    dout = torch.from_numpy(_dout(300))
    (m.forward_rows(rows) * dout).sum().backward()
    got = [rows.grad] + [p.grad for p in m.parameters()]
    rows2 = rows.detach().clone().requires_grad_()
    m.zero_grad()
    ws, bs = TF.pack_params(dict(m.named_parameters()), 10, "float32")
    (TF.fused_nerf_fwd_plain(rows2, ws, bs, 10, "float32")
     * dout).sum().backward()
    want = [rows2.grad] + [p.grad for p in m.parameters()]
    for a, b in zip(got, want):
        assert _rel_l2(a.numpy(), b.numpy()) < 1e-5


def test_init_matches_flax_statistics():
    """flax's Dense init: lecun_normal kernels (truncated to 2 std, variance
    1/fan_in) and zero biases; per-layer std within 5% of flax's."""
    _, params = _flax()
    m = NeRFMLP(10, "float32", generator=torch.Generator().manual_seed(0))
    for name, p in params["params"].items():
        w = getattr(m, name).weight.detach().numpy()
        k = p["kernel"]
        assert w.shape == k.T.shape
        np.testing.assert_array_equal(getattr(m, name).bias.detach().numpy(),
                                      0.0)
        bound = 2.0 * np.sqrt(1.0 / k.shape[0]) / 0.87962566103423978
        assert np.abs(w).max() <= bound + 1e-6
        assert np.abs(k).max() <= bound + 1e-6
        if w.size >= 1000:
            assert abs(w.std() / k.std() - 1.0) < 0.05, name


def test_packed_follows_optimizer_steps():
    """The no-grad cache repacks after an optimizer step changed the
    parameters in place; it never serves stale weights."""
    m = NeRFMLP(10, "float32")
    first = m.packed()
    assert m.packed() is first
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    rows = torch.from_numpy(_rows(50))
    m.forward_rows(rows).sum().backward()
    opt.step()
    ws, bs = m.packed()
    want_w, want_b = TF.pack_params({k: v.detach() for k, v in
                                     m.state_dict().items()}, 10, "float32")
    for a, b in zip(ws + bs, want_w + want_b):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not torch.equal(ws[0], first[0][0])


def _swizzle_offsets(R, C):
    """The image layout restated in numpy: element (r, k) of an (R x C)
    operand lies in slab (r // nt) * (C / 64) + k // 64 (nt = min(R, 128)
    rows, 64 columns, nt * 128 bytes), at byte (r % nt) * 128 + 16 *
    ((k % 64) // 8 XOR r % 8) + 2 * (k % 8) of it."""
    nt = min(R, 128)
    r, k = np.meshgrid(np.arange(R), np.arange(C), indexing="ij")
    slab = (r // nt) * (C // 64) + k // 64
    byte = (slab * nt * 128 + (r % nt) * 128
            + 16 * (((k % 64) // 8) ^ (r % 8)) + 2 * (k % 8))
    return byte // 2


@pytest.mark.parametrize("transposed", [False, True])
def test_weight_image_holds_each_weight_once_at_its_swizzled_offset(
        transposed):
    """At the flagship widths, every weight the bf16 backward kernel
    streams (layers 0-8, 10, 11) and its transpose: the image holds each
    element exactly once, at the byte offset of the 128-byte swizzle
    formula, and unpacking returns the weight."""
    state = {k: v.detach() for k, v in NeRFMLP(10, "float32").state_dict()
             .items()}
    # distinct values, so a misplaced element cannot match by accident
    for k in state:
        if k.endswith(".weight"):
            n = state[k].numel()
            state[k] = (torch.arange(n, dtype=torch.float32) * 2 + 1
                        ).reshape(state[k].shape)
    ws, _ = TF.pack_params(state, 10, "float32")
    image, offs = TF.weight_image(ws)
    parts, total = TF.image_layout(ws)
    assert image.numel() == total
    assert total == sum(ws[l].numel() for l in TF.IMAGE_LAYERS) * 2
    assert all(offs[TF.N_W * t + l] == -1 for l in (9, 12) for t in (0, 1))
    img = image.numpy()
    covered = np.zeros(total, np.int64)
    for l, t, R, C, o in parts:
        w = ws[l].numpy()
        x = w.T if t else w
        assert (R, C) == x.shape and offs[TF.N_W * t + l] == o
        pos = o + _swizzle_offsets(R, C)
        np.add.at(covered, pos.reshape(-1), 1)
        if t == transposed:
            np.testing.assert_array_equal(img[pos], x)
            np.testing.assert_array_equal(
                TF.unpack_image(image, R, C, o).numpy(), x)
            np.testing.assert_array_equal(
                TF.image_offset(R, C).numpy(), _swizzle_offsets(R, C))
    assert (covered == 1).all()
