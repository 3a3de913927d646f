"""The port with ``k_neigh`` != 4 against the JAX package on the CPU: the
warp-blend and the weighted scatter at k in {2, 8} against their TPU
kernels in interpret mode, ``AnimNeRFSystem``'s k_neigh range, a
checkpoint's k_neigh, and, at k_neigh=8, the whole tiny-rig compacted
render (vs ``Renderer.render_frame``) and the training step's loss terms
and gradients (vs ``rows_compact_loss_fn``), under the bounds of the k=4
tests (``tests/test_torch_render.py``, ``tests/test_torch_train.py``).
Those two run on the tiny rig with one-hot LBS weights: the seeded rig's
weights differ from vertex to vertex, so the confidence gate keeps
neighbour 0 alone and k_neigh would change nothing."""

from __future__ import annotations

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_render import (  # noqa: E402
    CKPT,
    _jax_frame,
    rigid_lbs_torch,
)
from test_torch_train import (  # noqa: E402
    check_details,
    check_grads,
    jax_reference,
    port_step,
)

from animnerf_tpu.ops.knn_pallas import knn_pallas  # noqa: E402
from animnerf_tpu_torch.data.synthetic import make_body_model  # noqa: E402
from animnerf_tpu_torch.system import AnimNeRFSystem  # noqa: E402

torch.set_num_threads(1)


def _frame():
    """The tiny JAX rig's frame: Morton cloud, permuted table (LBS columns
    coarsened so the confidence gate opens as well as closes)."""
    from test_torch_warp import J, _frame as warp_frame

    import animnerf_tpu.models.warp as JW

    jctx, _ = warp_frame()
    jv, jt = JW._morton_inputs(jctx)
    jt = jt.at[..., :J].set(jnp.round(jt[..., :J] * 2.0) / 2.0)
    return jctx, jv, jt, J


@pytest.mark.parametrize("k", [2, 8])
def test_warp_blend_plain_matches_kernel_at_k(k):
    """warp_blend_fwd_plain with k neighbour rows against the TPU
    warp-blend kernel in interpret mode, on the packed kNN's k neighbours:
    the sums over k in the same order, f32 rounding only (atol 1e-5)."""
    from animnerf_tpu.ops.warp_blend import warp_blend_fwd_pallas
    from animnerf_tpu_torch.ops.warp_blend import warp_blend_fwd

    jctx, jv, jt, J = _frame()
    rng = np.random.default_rng(20 + k)
    verts = np.asarray(jctx.verts)
    N = 700
    pts = (verts[:, rng.integers(0, verts.shape[1], N)]
           + rng.normal(scale=0.06, size=(1, N, 3))).astype(np.float32)
    d, i = knn_pallas(jnp.asarray(pts), jv, k=k, packed=True,
                      transposed_out=True, interpret=True)
    rows = np.zeros((1, 8, N), np.float32)
    rows[0, :3] = pts[0].T
    ja = warp_blend_fwd_pallas(jnp.asarray(rows), None, d, i, jt, J, 0.1,
                               0.9, interpret=True, tile_n=256,
                               inputs_t=True, xyz_rows=True)
    ta = warp_blend_fwd(torch.from_numpy(rows), torch.tensor(np.asarray(d)),
                        torch.tensor(np.asarray(i)),
                        torch.tensor(np.asarray(jt)), J, 0.1, 0.9)
    assert ta[1].shape == (1, k, N)
    for name, a, b in zip(("out", "w", "bf"), ja, ta):
        np.testing.assert_allclose(b.numpy(), np.asarray(a)[..., :N],
                                   atol=1e-5, err_msg=name)
    w = ta[1].numpy()
    assert (w == 0).any() and (w[:, 1:] > 0).any()


@pytest.mark.parametrize("k", [2, 8])
def test_weighted_scatter_plain_matches_kernel_at_k(k):
    """weighted_scatter_rows_plain with k neighbour rows against the TPU
    scatter kernel in interpret mode: f32 sums in another order,
    rtol/atol 1e-5."""
    from animnerf_tpu.ops.blend import weighted_scatter_rows_pallas
    from animnerf_tpu_torch.ops.blend import weighted_scatter_rows

    B, N, V = 2, 300, 1024
    rng = np.random.default_rng(30 + k)
    idx = rng.integers(100, 140, size=(B, k, N)).astype(np.int32)
    idx[..., ::31] = rng.integers(V - 20, V, size=idx[..., ::31].shape)
    w = rng.uniform(size=(B, k, N)).astype(np.float32)
    g = rng.normal(size=(B, 16, N)).astype(np.float32)
    ref = np.asarray(weighted_scatter_rows_pallas(
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(g), V, tile_n=128,
        tile_v=256, interpret=True, transposed_in=True, g_t=True))
    got = weighted_scatter_rows(*(torch.from_numpy(a) for a in (idx, w, g)),
                                V)
    assert got.shape == (B, V, 16)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def _system(cfg):
    return AnimNeRFSystem(cfg, make_body_model(64, 8, seed=1), device="cpu")


def test_system_takes_k_neigh_1_to_16():
    """Any k_neigh from 1 to the vertex count (64 here), as the JAX
    package takes it; 0 is refused."""
    base = {"n_samples": 8, "n_importance": 4}
    for k in (1, 4, 8, 16, 17, 24, 40, 64):
        assert _system(dict(base, k_neigh=k)).scene_cfg.k_neigh == k
    assert _system(base).scene_cfg.k_neigh == 4
    with pytest.raises(ValueError, match="at least 1"):
        _system(dict(base, k_neigh=0))


def test_checkpoint_k_neigh_reaches_the_config(tmp_path):
    """A JAX checkpoint's meta.json k_neigh sets the port's scene config."""
    from animnerf_tpu_torch.utils.convert import load_checkpoint

    ck_dir = tmp_path / "ckpt"
    shutil.copytree(CKPT, ck_dir)
    meta = json.loads((ck_dir / "meta.json").read_text())
    assert meta["cfg"]["k_neigh"] == 4
    meta["cfg"]["k_neigh"] = 8
    (ck_dir / "meta.json").write_text(json.dumps(meta))
    ck = load_checkpoint(str(ck_dir))
    system = _system(ck["cfg"])
    assert system.scene_cfg.k_neigh == 8
    system.load_anim_nerf(ck["anim_nerf"])


def test_render_frame_k8_matches_jax():
    """The whole tiny-rig compacted render at k_neigh=8 (f32) against the
    JAX Renderer with its kernels in interpret mode, on the rig with
    one-hot LBS weights (so that the confidence gate blends up to 8
    neighbours): the bounds of the k=4 test (atol 1e-4, depths 5e-4). The
    k_neigh=4 render of the same rig differs."""
    from animnerf_tpu_torch.render.inference import Renderer
    from animnerf_tpu_torch.utils.convert import nerf_params_from_flax

    cfg, params, bp, tmpl, rays, (img_j, mask_j, depth_j) = _jax_frame(
        "float32", 16, 16, k_neigh=8, rigid=True)
    an = jax.tree.map(np.asarray, params["anim_nerf"])
    out = {}
    for k in (8, 4):
        system = AnimNeRFSystem(
            dict(cfg, k_neigh=k),
            rigid_lbs_torch(make_body_model(128, 12, seed=0), 12),
            device="cpu")
        assert system.scene_cfg.k_neigh == k
        system.load_anim_nerf({n: nerf_params_from_flax(v)
                               for n, v in an.items()})
        r = Renderer(system, device="cpu")
        out[k] = r.render_frame(bp, tmpl, rays)
        n_c, n_f = r.last_counts
        assert n_c > 0 and n_f > 0, "the frame must have survivors"
    img, mask, depth = out[8]
    assert (mask > 1e-3).any(), "the body must be visible"
    np.testing.assert_allclose(img, img_j, atol=1e-4)
    np.testing.assert_allclose(mask, mask_j, atol=1e-4)
    np.testing.assert_allclose(depth, depth_j, atol=5e-4)
    assert np.abs(out[4][0] - img).max() > 1e-3


@pytest.fixture(scope="module")
def ref8():
    """The JAX step at k_neigh=8 on the rig with one-hot LBS weights."""
    return jax_reference(k_neigh=8, rigid_lbs=True)


@pytest.fixture(scope="module")
def port8(ref8):
    return port_step(ref8)


def test_rows_compact_k8_details_match_jax(ref8, port8):
    """The k_neigh=8 training step's details against JAX's: the bounds of
    ``test_rows_compact_details_match_jax`` (rtol 1e-5, normal terms 2e-3)."""
    assert port8[0].scene_cfg.k_neigh == 8
    check_details(ref8, port8)


def test_rows_compact_k8_grads_match_jax(ref8, port8):
    """The k_neigh=8 step's gradients: the hybrid rel-L2 bound (2e-3) of
    ``test_rows_compact_grads_match_jax``; the warp blended more than one
    neighbour, so k_neigh reached the loss."""
    check_grads(ref8, port8)
    system4, d4 = port_step(dict(ref8, cfg=dict(ref8["cfg"], k_neigh=4)))
    assert system4.scene_cfg.k_neigh == 4
    assert abs(float(d4["loss"].detach())
               - float(port8[1]["loss"].detach())) > 1e-6
