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


# -------------------------------------- the backward's two plain pieces

# the kernel's scratch layout restated (csrc/fused_mlp_bwd.cu h_col, g_col):
# H arrays 0 enc (E) | 1..8 h0..h7 (256) | 9 hf (256) | 10 hd (128), then G
# arrays 0..7 d0..d7 (256) | 8 d_hf (256) | 9 d_hd (128), each a
# point-major (chunk, width) block
def _np_scratch(scratch, chunk, E):
    hw = [E] + [256] * 9 + [128]
    gw = [256] * 9 + [128]
    HW = sum(hw)
    h_col = [0] + [E + (h - 1) * 256 for h in range(1, 11)]
    g_col = [g * 256 for g in range(10)]
    H = [scratch[h_col[h] * chunk:(h_col[h] + hw[h]) * chunk].reshape(
        chunk, hw[h]) for h in range(11)]
    G = [scratch[(HW + g_col[g]) * chunk:(HW + g_col[g] + gw[g]) * chunk]
         .reshape(chunk, gw[g]) for g in range(10)]
    return H, G


def _np_bf16(x):
    return np.asarray(np.asarray(x, np.float32).astype(jnp.bfloat16),
                      np.float64)


def _np_wgrad(scratch, heads, rows, chunk, E, bf16):
    """wgrad_from_scratch_plain restated in numpy f64: the flat gradients
    dW_0..12, db_0..12 (pack_params' shapes), padded to a multiple of 64."""
    H, G = _np_scratch(np.asarray(scratch, np.float64), chunk, E)
    H = [h[:rows] for h in H]
    G = [g[:rows] for g in G]
    hc = np.asarray(heads, np.float64).reshape(-1)[:chunk * 4].reshape(
        chunk, 4)[:rows]
    hb = _np_bf16(hc) if bf16 else hc
    dw = [np.einsum("pn,pk->nk", G[g], H[h]) for g, h in
          [(0, 0), (1, 1), (2, 2), (3, 3), (4, 4), (5, 5), (6, 6), (7, 7),
           (4, 0)]]
    dw9 = np.zeros((8, 256))
    dw9[0] = np.einsum("p,pk->k", hb[:, 3], H[8])
    dw12 = np.zeros((8, 128))
    dw12[:3] = np.einsum("pc,pk->ck", hb[:, :3], H[10])
    dw += [dw9, np.einsum("pn,pk->nk", G[8], H[8]),
           np.einsum("pn,pk->nk", G[9], H[9]), dw12]
    db = [G[g].sum(0) for g in range(8)] + [np.zeros(256)]
    db9 = np.zeros(8)
    db9[0] = hc[:, 3].sum()
    db12 = np.zeros(8)
    db12[:3] = hc[:, :3].sum(0)
    db += [db9, G[8].sum(0), G[9].sum(0), db12]
    flat = np.concatenate([t.ravel() for t in dw + db])
    return np.pad(flat, (0, (-flat.size) % 64))


def _scratch_case(name, M, chunk):
    """bwd_scratch_plain over M points padded to `chunk` as the kernel pads
    a chunk: zero coordinates, zero output cotangents."""
    _, params = _flax()
    ws, bs = TF.pack_params(nerf_params_from_flax(params), 10, name)
    pad = ((0, 0), (0, 0), (0, chunk - M))
    d_xyz, scratch, heads = TF.bwd_scratch_plain(
        torch.from_numpy(np.pad(_rows(M), pad)), ws, bs,
        torch.from_numpy(np.pad(_dout(M), pad)), 10, name)
    return d_xyz[..., :M], scratch, heads


def test_scratch_views_follow_the_kernel_layout():
    """scratch_views cuts a flat scratch at the kernel's offsets (the
    numpy restatement above), widths from the encoding block E."""
    chunk, E = 8, 64
    n = chunk * 2 * (9 * 256 + 128) + chunk * E
    flat = torch.arange(n, dtype=torch.float64)
    H, G = TF.scratch_views(flat, chunk, E)
    Hn, Gn = _np_scratch(flat.numpy(), chunk, E)
    assert len(H) == 11 and len(G) == 10
    for a, b in zip(H + G, Hn + Gn):
        np.testing.assert_array_equal(a.numpy(), b)
    assert G[-1][-1, -1] == n - 1


@pytest.mark.parametrize("name,M", [("bfloat16", 200), ("bfloat16", 256),
                                    ("float32", 300)])
def test_wgrad_from_scratch_plain_matches_numpy_f64(name, M):
    """wgrad_from_scratch_plain (f64 accumulation) against the numpy f64
    restatement over a chunk padded to a multiple of 128; the padded rows
    carry zero cotangents, so taking them in changes nothing, even with
    garbage in their H rows."""
    chunk = -(-M // 128) * 128
    _, scratch, heads = _scratch_case(name, M, chunk)
    assert scratch.dtype == TF._dtype(name) and heads.shape == (chunk, 4)
    want = _np_wgrad(scratch.float().numpy(), heads.numpy(), M, chunk, 64,
                     name == "bfloat16")
    got = TF.wgrad_from_scratch_plain(scratch, heads, M, chunk,
                                      torch.float64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)
    got32 = TF.wgrad_from_scratch_plain(scratch, heads, M, chunk)
    assert got32.dtype == torch.float32
    assert _rel_l2(got32.numpy(), want) < 1e-6
    # the padded rows: zero cotangents, nothing added
    H, G = TF.scratch_views(scratch, chunk, 64)
    for g in G:
        assert torch.count_nonzero(g[M:]) == 0
    assert torch.count_nonzero(heads[M:]) == 0
    junk = scratch.clone()
    for h in TF.scratch_views(junk, chunk, 64)[0]:
        h[M:] = 1e3
    padded = TF.wgrad_from_scratch_plain(junk, heads, chunk, chunk,
                                         torch.float64)
    np.testing.assert_allclose(padded.numpy(), got.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("name,M,tol", [("float32", 200, 1e-5),
                                        ("bfloat16", 200, 2e-2)])
def test_plain_pieces_compose_to_the_tpu_kernel(name, M, tol):
    """bwd_scratch_plain over a padded chunk, then wgrad_from_scratch_plain
    over its M rows, against the TPU kernel's fused_nerf_bwd in interpret
    mode (the tolerances of test_fused_backward_matches_kernel), and the
    same flat gradients as fused_nerf_bwd_plain."""
    _, params = _flax()
    rows, dout = _rows(M), _dout(M)
    ref = _jax_bwd(params, rows, dout, jnp.dtype(name))
    chunk = -(-M // 128) * 128
    d_xyz, scratch, heads = _scratch_case(name, M, chunk)
    flat = TF.wgrad_from_scratch_plain(scratch, heads, M, chunk)
    ws, bs = TF.pack_params(nerf_params_from_flax(params), 10, name)
    d_ws, d_bs = TF._split_grads(flat, ws, bs)
    assert d_xyz.shape == (1, 8, M)
    assert _rel_l2(d_xyz.numpy(), ref[0]) < tol, "d_xyz"
    for i, (a, b) in enumerate(zip(d_ws + d_bs, ref[1] + ref[2])):
        assert a.shape == b.shape
        if np.abs(b).max() == 0:
            np.testing.assert_array_equal(a.numpy(), 0.0)
        else:
            assert _rel_l2(a.numpy(), b) < tol, f"gradient {i}"
    whole = TF.fused_nerf_bwd_plain(torch.from_numpy(rows), ws, bs,
                                    torch.from_numpy(dout), 10, name)
    for a, b in zip(d_ws + d_bs, whole[1] + whole[2]):
        assert _rel_l2(a.numpy(), b.numpy()) < 1e-6


def test_fused_nerf_wgrad_takes_the_plain_version_on_the_cpu():
    """The wgrad pass's wrapper: the plain version for CPU tensors, rows in
    1..chunk."""
    M, chunk = 130, 256
    _, scratch, heads = _scratch_case("bfloat16", M, chunk)
    got = TF.fused_nerf_wgrad(scratch, heads, M, chunk)
    want = TF.wgrad_from_scratch_plain(scratch, heads, M, chunk)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for bad in (0, chunk + 1):
        with pytest.raises(ValueError):
            TF.fused_nerf_wgrad(scratch, heads, bad, chunk)


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


# ------------------------------------------- the forward's weight image


def _state(n_freqs, seed=0):
    mlp = NeRFMLP(n_freqs, "float32",
                  generator=torch.Generator().manual_seed(seed))
    return {k: v.detach() for k, v in mlp.state_dict().items()}


@pytest.mark.parametrize("n_freqs", [4, 7, 10])
def test_weight_image_pads_encoding_columns_to_64(n_freqs):
    """The bf16 kernels read the encoding in 64-column blocks: the image's
    parts of layers 0 and 8 (the encoding halves) unpack to ws[l] followed
    by zero columns up to enc_cols(n_freqs); every other part is the
    unpadded weight. At the flagship's 10 frequencies (E = 64) nothing is
    padded and the whole image is the slab layout restated in numpy, part
    after part in IMAGE_PARTS order."""
    ws, _ = TF.pack_params(_state(n_freqs), n_freqs, "bfloat16")
    E = TF.enc_rows(n_freqs)
    Ep = TF.enc_cols(n_freqs)
    assert Ep % 64 == 0 and E <= Ep < E + 64
    image, offs = TF.weight_image(ws)
    for l in (0, TF.DEPTH):
        got = TF.unpack_image(image, 256, Ep, offs[l])
        np.testing.assert_array_equal(got[:, :E].float().numpy(),
                                      ws[l].float().numpy())
        np.testing.assert_array_equal(got[:, E:].float().numpy(), 0.0)
        got_t = TF.unpack_image(image, Ep, 256, offs[TF.N_W + l])
        np.testing.assert_array_equal(got_t.float().numpy(),
                                      got.t().float().numpy())
    for l in (1, 2, 3, 4, 5, 6, 7, 10, 11):
        N, K = ws[l].shape
        np.testing.assert_array_equal(
            TF.unpack_image(image, N, K, offs[l]).float().numpy(),
            ws[l].float().numpy())
    if n_freqs == 10:
        want = np.zeros(image.numel(), np.float32)
        o = 0
        for l, t in TF.IMAGE_PARTS:
            x = ws[l].float().numpy()
            x = x.T if t else x
            want[o + _swizzle_offsets(*x.shape)] = x
            assert offs[TF.N_W * t + l] == o
            o += x.size
        assert o == image.numel()
        np.testing.assert_array_equal(image.float().numpy(), want)


def test_enc_cols_takes_every_n_freqs_the_16_aligned_kernel_took():
    """The wmma forward took a bf16 encoding block E = enc_rows(n_freqs)
    that is a multiple of 16, with 2^j formed as an int shift (right up to
    n_freqs 31). enc_cols takes each of those, and the n_freqs between
    (their encoding is zero-padded alike), up to 192 columns; past 31 it
    raises."""
    old = [f for f in range(32) if TF.enc_rows(f) % 16 == 0]
    assert {1, 2, 4, 7, 9, 10, 31} <= set(old)
    for f in range(TF.MAX_FREQS + 1):
        Ep = TF.enc_cols(f)
        assert Ep % 64 == 0 and 3 + 6 * f <= Ep <= 192
        assert Ep == -(-TF.enc_rows(f) // 64) * 64
    assert TF.enc_cols(10) == TF.bwd_layout(10).cols == 64
    for f in (-1, TF.MAX_FREQS + 1):
        with pytest.raises(ValueError, match="n_freqs"):
            TF.enc_cols(f)


def test_prebuilt_image_must_match_the_weights():
    """A caller's cached image is checked against the weights it is
    handed with: its length, dtype and part offsets must be those of
    weight_image(ws) (n_freqs 4 and 10 pad to the same layout)."""
    ws4, _ = TF.pack_params(_state(4), 4, "bfloat16")
    ws10, _ = TF.pack_params(_state(10), 10, "bfloat16")
    img, offs = TF.weight_image(ws10)
    got, c_offs = TF._check_image((img, offs), ws10)
    assert got is img and list(c_offs) == offs
    assert TF.weight_image(ws4)[1] == offs
    bad_offs = list(offs)
    bad_offs[0], bad_offs[1] = bad_offs[1], bad_offs[0]
    for bad in ((img[:-64], offs), (img.float(), offs), (img, bad_offs)):
        with pytest.raises(ValueError, match="weight image"):
            TF._check_image(bad, ws10)


@pytest.mark.parametrize("n_freqs", [4, 10])
def test_fused_forward_bf16_matches_kernel_at_n_freqs(n_freqs):
    """The bf16 plain forward (the kernel's math, zero-padded encoding
    included) against the TPU kernel in interpret mode at a narrow and the
    flagship encoding: the same rounding points, the f32 accumulation
    order differs, which can flip a bf16 rounding between layers (rgb atol
    2e-2, sigma atol 3e-2 + rtol 2e-2, as the flagship test)."""
    mod = FlaxNeRF(freqs_xyz=n_freqs, freqs_dir=0, use_view=False,
                   compute_dtype=jnp.float32)
    params = jax.tree.map(np.asarray, mod.init(jax.random.PRNGKey(3),
                                               jnp.zeros((2, 3))))
    rows = _rows(256, seed=5)
    jws, jbs = JF.pack_params(params, n_freqs, dtype=jnp.bfloat16)
    with jax.disable_jit():
        ref = np.asarray(JF.fused_nerf_fwd(
            jnp.asarray(rows), jws, jbs, n_freqs=n_freqs, tile=256,
            dtype=jnp.bfloat16, interpret=True))
    ws, bs = TF.pack_params(nerf_params_from_flax(params), n_freqs,
                            "bfloat16")
    out = TF.fused_nerf_fwd(torch.from_numpy(rows), ws, bs, n_freqs,
                            "bfloat16").numpy()
    np.testing.assert_allclose(out[0, 0:3], ref[0, 0:3], atol=2e-2)
    np.testing.assert_allclose(out[0, 3], ref[0, 3], atol=3e-2, rtol=2e-2)
    np.testing.assert_array_equal(out[0, 4:], 0.0)


def test_packed_image_is_built_once_until_reloaded_moved_or_stepped():
    """Serving's cached weight image lives as long as the packed weights:
    the same object across forwards, rebuilt after load_state_dict, a
    device move and an optimizer step, and always the image of the
    current packed weights."""
    m = NeRFMLP(10, "bfloat16")

    def fresh():
        img = m.packed_image()
        want, offs = TF.weight_image(m.packed()[0])
        assert img[1] == offs
        np.testing.assert_array_equal(img[0].float().numpy(),
                                      want.float().numpy())
        return img

    first = fresh()
    assert m.packed_image() is first
    m.load_state_dict(_state(10, seed=1))
    second = fresh()
    assert second is not first
    assert not torch.equal(second[0], first[0])
    assert m.packed_image() is second
    m.to("cpu")
    third = fresh()
    assert third is not second
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    m.forward_rows(torch.from_numpy(_rows(50))).sum().backward()
    opt.step()
    fourth = fresh()
    assert fourth is not third
    assert not torch.equal(fourth[0], third[0])
