"""The fused MLP's float32 path (csrc/mlp_f32.cu on mlp_f32_tile.cuh):
the weight image its kernels read (``f32_image``: every streamed weight
reduction-major, W_l^T for the forward and W_l for the dgrad) read back
against ``pack_params`` bit for bit; the shared memory of the blocks the
wrappers pick at every n_freqs; the f32 plain forward and backward against
the TPU kernels in interpret mode at the encodings the other files leave
out; and the wrappers taking the plain versions for CPU tensors."""

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
from test_torch_fused_mlp_freqs import _jax_bwd, _params  # noqa: E402

from animnerf_tpu.ops import fused_mlp as JF  # noqa: E402
from animnerf_tpu_torch.models.nerf import NeRFMLP  # noqa: E402
from animnerf_tpu_torch.ops import _build  # noqa: E402
from animnerf_tpu_torch.ops import fused_mlp as TF  # noqa: E402
from animnerf_tpu_torch.utils.convert import nerf_params_from_flax  # noqa: E402

torch.set_num_threads(1)


def _distinct_ws(n_freqs):
    """pack_params' f32 weights at n_freqs with every weight distinct (so
    a misplaced element cannot match by accident)."""
    state = {k: v.detach() for k, v in NeRFMLP(n_freqs, "float32")
             .state_dict().items()}
    for k in state:
        if k.endswith(".weight"):
            n = state[k].numel()
            state[k] = (torch.arange(n, dtype=torch.float32) * 2 + 1
                        ).reshape(state[k].shape)
    return TF.pack_params(state, n_freqs, "float32")[0]


@pytest.mark.parametrize("n_freqs", [4, 10, 16])
def test_f32_image_reads_back_to_pack_params(n_freqs):
    """At n_freqs 4 and 10 (a 64-column encoding block) and 16 (128): each
    part of the f32 image, read in the kernels' order, is a whole
    row-major block, W_l^T (K x N) for the forward and W_l (N x K) for the
    dgrad, equal bit for bit to pack_params' weight (layers 0 and 8
    zero-padded to the block's columns); its KS-row slabs are contiguous
    whole rows; the parts sit at weight_image's offsets in IMAGE_PARTS
    order and fill the image exactly (tolerance: none, a copy)."""
    ws = _distinct_ws(n_freqs)
    E, Ep = TF.enc_rows(n_freqs), TF.bwd_layout(n_freqs).cols
    assert Ep == TF.enc_cols(n_freqs) == (64 if n_freqs <= 10 else 128)
    image, offs = TF.f32_image(ws)
    assert image.dtype == torch.float32
    assert offs == TF.weight_image(ws)[1]
    img = image.numpy()
    o = 0
    for l, t in TF.IMAGE_PARTS:
        w = ws[l].numpy()
        if l in (0, TF.DEPTH):
            w = np.pad(w, ((0, 0), (0, Ep - E)))
        N, K = w.shape
        assert offs[TF.N_W * t + l] == o and o % 4 == 0
        # forward: reduction k, outputs n; dgrad: reduction n, outputs k
        rows, cols = (N, K) if t else (K, N)
        block = img[o:o + w.size].reshape(rows, cols)
        np.testing.assert_array_equal(block, w if t else w.T)
        assert rows % TF.F32_KS == 0
        slab = img[o:o + TF.F32_KS * cols].reshape(TF.F32_KS, cols)
        np.testing.assert_array_equal(slab, (w if t else w.T)[:TF.F32_KS])
        R, C = (K, N) if t else (N, K)
        np.testing.assert_array_equal(
            TF.unpack_image(image, R, C, o, f32=True).numpy(),
            w.T if t else w)
        o += w.size
    assert o == image.numel()


@pytest.mark.parametrize("n_freqs", range(TF.MAX_BWD_FREQS + 1))
def test_f32_blocks_fit_shared_memory(n_freqs):
    """The instantiation the wrappers pick at n_freqs (the encoding block
    enc_cols(n_freqs)) and its shared memory, as csrc/mlp_f32.cu lays it
    out: the forward and the backward's main kernel each within the
    H100's 232,448 B a block with a ring of at least 3 slab stages; the
    totals the source states (214,016 B / 230,400 B forward, 232,448 B
    backward)."""
    ec, stages, nbytes = TF.f32_smem(n_freqs)
    assert ec == TF.enc_cols(n_freqs) and 3 + 6 * n_freqs <= ec
    assert 3 <= stages <= 4 and nbytes <= 232448
    assert nbytes == (214016 if ec == 64 else 230400)
    ec, stages, nbytes = TF.f32_smem(n_freqs, backward=True)
    assert ec == TF.bwd_layout(n_freqs).cols
    assert stages == (4 if ec == 64 else 3) and nbytes == 232448


def test_f32_forward_blocks_fit_above_the_backward_range():
    """The forward takes n_freqs up to 31 (encoding blocks of 192
    columns from 21 on): 3 slab stages, 230,400 B."""
    for n_freqs in range(TF.MAX_BWD_FREQS + 1, TF.MAX_FREQS + 1):
        ec, stages, nbytes = TF.f32_smem(n_freqs)
        assert ec == 192 and stages == 3 and nbytes == 230400
    with pytest.raises(ValueError, match="n_freqs"):
        TF.f32_smem(TF.MAX_BWD_FREQS + 1, backward=True)


def _jax_fwd(params, rows, n_freqs):
    ws, bs = JF.pack_params(params, n_freqs, dtype=jnp.float32)
    M = rows.shape[-1]
    x = jnp.pad(jnp.asarray(rows), ((0, 0), (0, 0), (0, (-M) % 256)))
    out = JF.fused_nerf_fwd(x, ws, bs, n_freqs=n_freqs, tile=256,
                            dtype=jnp.float32, interpret=True)
    return np.asarray(out)[..., :M]


@pytest.mark.parametrize("n_freqs", [4, 16])
def test_f32_forward_matches_kernel_at_n_freqs(n_freqs):
    """The f32 plain forward against the TPU kernel in interpret mode at a
    narrow encoding (27 rows) and one in the 128-column block (99 rows):
    f32 throughout, only the dot's summation order differs (the
    10-frequency test's bounds: rgb atol 1e-5, sigma atol 1e-4)."""
    params = _params(n_freqs, seed=1)
    rows = _rows(300, seed=3)
    ref = _jax_fwd(params, rows, n_freqs)
    ws, bs = TF.pack_params(nerf_params_from_flax(params), n_freqs,
                            "float32")
    out = TF.fused_nerf_fwd(torch.from_numpy(rows), ws, bs, n_freqs,
                            "float32").numpy()
    np.testing.assert_allclose(out[0, 0:3], ref[0, 0:3], atol=1e-5)
    np.testing.assert_allclose(out[0, 3], ref[0, 3], atol=1e-4)
    np.testing.assert_array_equal(out[0, 4:], 0.0)


def test_f32_backward_matches_kernel_at_16_freqs():
    """The f32 plain backward against the TPU kernel in interpret mode at
    n_freqs 16 (104 encoding rows in the 128-column block; 4, 8, 12 and 20
    are in test_torch_fused_mlp_freqs.py): d_xyz and every gradient within
    the 10-frequency case's rel-L2 1e-5 (summation order only), on 512
    points."""
    M, n_freqs = 512, 16
    params = _params(n_freqs, seed=2)
    rows, dout = _rows(M, seed=4), _dout(M, seed=5)
    ref = _jax_bwd(params, rows, dout, n_freqs, jnp.float32)
    ws, bs = TF.pack_params(nerf_params_from_flax(params), n_freqs,
                            "float32")
    out = TF.fused_nerf_bwd(torch.from_numpy(rows), ws, bs,
                            torch.from_numpy(dout), n_freqs, "float32")
    assert _rel_l2(out[0].numpy(), ref[0]) < 1e-5, "d_xyz"
    for i, (a, b) in enumerate(zip(out[1] + out[2], ref[1] + ref[2])):
        assert a.shape == b.shape
        if np.abs(b).max() == 0:
            np.testing.assert_array_equal(a.numpy(), 0.0)
        else:
            assert _rel_l2(a.numpy(), b) < 1e-5, f"gradient {i}"


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On CPU tensors the f32 wrappers run the plain versions: no kernel
    library is loaded, no image is built, no launch is counted, and the
    results are the plain versions' bit for bit (tolerance: none), through
    the autograd Function too."""
    def no_library():
        raise AssertionError("the kernel library was asked for")

    def no_image(ws):
        raise AssertionError("a kernel image was built")

    monkeypatch.setattr(_build, "kernel_library", no_library)
    monkeypatch.setattr(TF, "kernel_image", no_image)
    monkeypatch.setattr(TF, "f32_image", no_image)
    _build.reset_launches()
    mlp = NeRFMLP(4, "float32", generator=torch.Generator().manual_seed(5))
    ws, bs = mlp.packed()
    rows = torch.from_numpy(_rows(130, seed=6))
    dout = torch.from_numpy(_dout(130, seed=7))
    out = TF.fused_nerf_fwd(rows, ws, bs, 4, "float32")
    assert torch.equal(out, TF.fused_nerf_fwd_plain(rows, ws, bs, 4,
                                                    "float32"))
    got = TF.fused_nerf_bwd(rows, ws, bs, dout, 4, "float32")
    want = TF.fused_nerf_bwd_plain(rows, ws, bs, dout, 4, "float32")
    for a, b in zip((got[0],) + got[1] + got[2],
                    (want[0],) + want[1] + want[2]):
        assert torch.equal(a, b)
    y = mlp.forward_rows(rows)
    y.backward(dout)
    assert all(p.grad is not None for p in mlp.parameters())
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_kernel_image_follows_the_compute_dtype():
    """kernel_image is the bf16 slab image for bf16 weights and the f32
    image for f32 weights (same part offsets, different layouts); a
    float32 NeRFMLP caches the f32 image for serving."""
    for n_freqs in (4, 10):
        w32 = _distinct_ws(n_freqs)
        w16 = tuple(w.to(torch.bfloat16) for w in w32)
        i32, o32 = TF.kernel_image(w32)
        i16, o16 = TF.kernel_image(w16)
        assert o32 == o16
        assert torch.equal(i32, TF.f32_image(w32)[0])
        assert torch.equal(i16, TF.weight_image(w16)[0])
        assert not torch.equal(i32, TF.weight_image(w32)[0])
    m = NeRFMLP(10, "float32")
    img, offs = m.packed_image()
    want, want_offs = TF.f32_image(m.packed()[0])
    assert offs == want_offs and torch.equal(img, want)
    assert m.packed_image()[0] is img
