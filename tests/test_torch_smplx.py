"""The SMPL-X slice against the JAX package, on the CPU: unpose, the
compacted render with the exact pre-pass, the rows-compacted training loss
and the body-param sizing, on an SMPL-X rig (J=55, hand PCA, jaw,
expression through 20 shape + expression dirs) with V=8300 vertices, just
above the packed kNN's 8192, so both packages take the exact kNN kernel.

The JAX side reaches its Pallas kernels in interpret mode
(``rows_interpret_forced``, ``fused_mlp="on"``); the port runs its
kernels' plain versions. Inputs come from numpy seeds.
"""

from __future__ import annotations

import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_train import _rel_l2_ok, jax_noise  # noqa: E402

from animnerf_tpu.data import synthetic as JS  # noqa: E402
from animnerf_tpu.models import body_params as JP  # noqa: E402
from animnerf_tpu.models import warp as JW  # noqa: E402
from animnerf_tpu.utils.interpret import rows_interpret_forced  # noqa: E402
from animnerf_tpu_torch.data import synthetic as TS  # noqa: E402
from animnerf_tpu_torch.models import warp as TW  # noqa: E402
from animnerf_tpu_torch.system import AnimNeRFSystem  # noqa: E402

torch.set_num_threads(1)

V, NB = 8300, 20


@pytest.fixture(scope="module")
def rigs():
    kw = dict(model_type="smplx", seed=0, num_betas=NB)
    return JS.make_body_model(V, **kw), TS.make_body_model(V, **kw)


def smplx_params(B, seed, zero_transl=False):
    """Every SMPL-X body param, from numpy."""
    rng = np.random.default_rng(seed)
    p = {k: rng.normal(scale=0.5 if k in ("betas", "transl", "expression")
                       else 0.3, size=(B, d)).astype(np.float32)
         for k, d in JP.PARAM_DIMS["smplx"].items()}
    if zero_transl:
        p["transl"][:] = 0.0
    return p


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def test_unpose_rows_matches_jax(rigs):
    """Rows-native unpose (the exact kNN on the Morton cloud, with the tile
    skip requested and ignored, then the warp-blend) against JAX
    unpose_rows with its kernels in interpret mode."""
    jm, tm = rigs
    bp, tmpl = smplx_params(1, 11), smplx_params(1, 12, zero_transl=True)
    jctx = JW.prepare_frame(jm, _j(bp), _j(tmpl))
    tctx = TW.prepare_frame(tm, _t(bp), _t(tmpl))
    rng = np.random.default_rng(13)
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
    # f32 geometry of a 55-joint chain, exact kNN: rounding only
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def _jax_cfg():
    from __graft_entry__ import _flagship_system

    cfg = _flagship_system(tiny=True)[0]
    cfg.model_type = "smplx"
    cfg.pose_dim = 63
    cfg.fused_mlp = "on"
    return cfg


@pytest.mark.parametrize("compute_dtype,atol", [
    ("float32", 1e-4),
    # bf16 rounds at the same points; f32 accumulation orders differ
    # (tests/test_torch_render.py)
    ("bfloat16", 2e-2),
])
def test_exact_prepass_render_matches_jax(rigs, compute_dtype, atol):
    """The compacted 16x16 render with prepass="exact" against JAX
    Renderer(prepass="exact").render_frame. The JAX package takes the dot
    form of the nearest-vertex distance on the CPU, so a sample within
    rounding of dis_threshold can survive on one side only; it is invalid
    on both (blended distance >= nearest distance), so the images agree.
    The fine pass is the one place where the two sides part by more than
    rounding: a fine-sample u within ulps of a CDF knot can take the
    neighbouring bin (ROADMAP.md section 3), which on some pose seeds
    moves one pixel past the f32 bound; this frame stays within it."""
    import animnerf_tpu.ops.fused_mlp as FM
    from animnerf_tpu.ops.ray_utils import camera_to_c2w, gen_rays
    from animnerf_tpu.render.inference import Renderer as JR
    from animnerf_tpu.training.system import AnimNeRFSystem as JSys
    from animnerf_tpu_torch.render.inference import Renderer
    from animnerf_tpu_torch.utils.convert import nerf_params_from_flax

    jm, tm = rigs
    cfg = _jax_cfg()
    cfg.compute_dtype = compute_dtype
    jsys = JSys(cfg, jm)
    params = jsys.init_params(jax.random.PRNGKey(0),
                              JP.init_body_params(cfg.num_frames, "smplx"))
    bp, tmpl = smplx_params(1, 3), smplx_params(1, 4, zero_transl=True)
    H = W = 16
    c2w = camera_to_c2w(np.eye(3), np.array([0.0, 0.0, 3.0]))
    rays = gen_rays(c2w, H, W, [1.2 * W, 1.2 * W], 0.1, 10.0).reshape(-1, 8)
    dot = FM._dot  # the bf16 shim of tests/test_torch_render.py
    FM._dot = lambda wt, h: dot(wt.astype(jnp.float32), h.astype(jnp.float32))
    try:
        with rows_interpret_forced():
            r = JR(jsys)
            r.prepass = "exact"
            r.compact_quantum = 256
            img_j, mask_j, depth_j = (np.asarray(o) for o in r.render_frame(
                params, _j(bp), _j(tmpl), rays))
    finally:
        FM._dot = dot
        jax.clear_caches()

    system = AnimNeRFSystem(dict(cfg), tm, device="cpu")
    an = jax.tree.map(np.asarray, params["anim_nerf"])
    system.load_anim_nerf({k: nerf_params_from_flax(v)
                           for k, v in an.items()})
    with pytest.raises(ValueError, match="prepass"):
        Renderer(system, device="cpu", prepass="exactly")
    rt = Renderer(system, device="cpu", prepass="exact")
    img, mask, depth = rt.render_frame(bp, tmpl, rays)
    n_c, n_f = rt.last_counts
    assert n_c > 0 and n_f > 0, "the frame must have survivors"
    assert (mask > 1e-3).any(), "the body must be visible"
    rb = Renderer(system, device="cpu")
    rb.render_frame(bp, tmpl, rays)
    assert n_c <= rb.last_counts[0], "exact keeps fewer than the boxes"
    np.testing.assert_allclose(img, img_j, atol=atol)
    np.testing.assert_allclose(mask, mask_j, atol=atol)
    np.testing.assert_allclose(depth, depth_j, atol=5 * atol)


B, R = 2, 16


def _batch(cfg):
    from test_parallel import _rays

    rng = np.random.default_rng(0)
    tmpl = smplx_params(B, 2, zero_transl=True)
    return {
        **smplx_params(B, 3),
        "frame_idx": np.arange(B, dtype=np.int32) % cfg.num_frames,
        "rays": _rays(B, R),
        "rgbs": rng.uniform(size=(B, R, 3)).astype(np.float32),
        "alphas": rng.uniform(size=(B, R, 1)).astype(np.float32),
        "fg_points": rng.normal(scale=0.2, size=(B, 16, 3)).astype(np.float32),
        "bg_points": rng.normal(scale=0.8, size=(B, 16, 3)).astype(np.float32),
        **{k + "_template": v for k, v in tmpl.items()},
    }


@pytest.fixture(scope="module")
def loss_ref(rigs):
    """One JAX value-and-grad of rows_compact_loss_fn on the SMPL-X rig,
    from random (nonzero) body params."""
    from test_rows_pipeline import rows_path_forced

    from animnerf_tpu.training.system import AnimNeRFSystem as JSys

    jm, _ = rigs
    cfg = _jax_cfg()
    system = JSys(cfg, jm)
    state = system.init_state(
        jax.random.PRNGKey(0), JP.init_body_params(cfg.num_frames, "smplx"),
        steps_per_epoch=10)
    rng = np.random.default_rng(5)
    params = dict(state.params, body_params={
        k: jnp.asarray(rng.normal(scale=0.1, size=v.shape).astype(np.float32))
        for k, v in state.params["body_params"].items()})
    batch = _batch(cfg)
    old = os.environ.get("ANIMNERF_MORTON_COMPACT")
    os.environ["ANIMNERF_MORTON_COMPACT"] = "1"
    try:
        with rows_path_forced():
            system.scene.__dict__["use_fused_mlp"] = True
            (_, details), grads = jax.value_and_grad(
                partial(system.rows_compact_loss_fn,
                        cap_c=R * cfg.n_samples), has_aux=True)(
                params, _j(batch), jax.random.PRNGKey(7), state.step)
    finally:
        if old is None:
            del os.environ["ANIMNERF_MORTON_COMPACT"]
        else:
            os.environ["ANIMNERF_MORTON_COMPACT"] = old
    jax.clear_caches()
    noise = jax_noise(jax.random.PRNGKey(7), 0, B, R, cfg.n_samples,
                      cfg.n_importance, V)
    return dict(cfg=cfg, batch=batch, params=params, noise=noise,
                details=jax.tree.map(np.asarray, details),
                grads=jax.tree.map(np.asarray, grads))


def test_rows_compact_loss_matches_jax(rigs, loss_ref):
    """Loss terms rtol 1e-5 (normal terms 2e-3) and every gradient leaf
    within 2e-3 rel-L2, the hand, jaw and expression params included: the
    bounds of tests/test_torch_train.py."""
    from animnerf_tpu_torch.training import system as TT
    from animnerf_tpu_torch.utils.convert import (
        nerf_params_from_flax,
        params_from_jax,
    )

    _, tm = rigs
    ref = loss_ref
    system = AnimNeRFSystem(dict(ref["cfg"]), tm, device="cpu")
    system.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                    ref["params"])))
    loss, td = TT.rows_compact_loss_fn(system, _t(ref["batch"]),
                                       ref["noise"])
    loss.backward()
    jd = ref["details"]
    assert int(jd["compact_overflow"]) == 0
    for k, v in jd.items():
        if k == "compact_overflow":
            continue
        tol = 2e-3 if k.startswith("loss_normals") or k == "loss" else 1e-5
        np.testing.assert_allclose(float(torch.as_tensor(td[k]).detach()),
                                   float(v), rtol=tol, err_msg=k)
    assert td["compact_count"] == int(jd["compact_count"]) > 0
    g = ref["grads"]
    for net in ("nerf", "nerf_fine"):
        want = nerf_params_from_flax(g["anim_nerf"][net])
        for name, p in getattr(system.scene, net).named_parameters():
            _rel_l2_ok(want[name].numpy(), p.grad.numpy(), f"{net}.{name}")
    assert set(g["body_params"]) == set(JP.PARAM_DIMS["smplx"])
    for k, v in g["body_params"].items():
        _rel_l2_ok(v, system.body_params[k].grad.numpy(), f"body.{k}")
        assert float(np.abs(v).max()) > 0, k


@pytest.mark.parametrize("model_type,pose_dim", [
    ("smpl", None), ("smpl", 33), ("smplx", None), ("smplx", 45)])
def test_system_body_params_match_jax_init(model_type, pose_dim):
    """The system sizes its body params as JAX init_body_params does with
    the configured pose_dim: 69 (SMPL) and 63 (SMPL-X) wide body_pose by
    default, not 3 * (J - 1)."""
    cfg = {"n_samples": 8, "n_importance": 4, "num_frames": 3,
           "model_type": model_type}
    if pose_dim is not None:
        cfg["pose_dim"] = pose_dim
    system = AnimNeRFSystem(cfg, TS.make_body_model(
        64, model_type=model_type, seed=1), device="cpu")
    want = JP.init_body_params(3, model_type, pose_dim=pose_dim)
    got = {k: tuple(p.shape) for k, p in system.body_params.items()}
    assert got == {k: tuple(v.shape) for k, v in want.items()}
