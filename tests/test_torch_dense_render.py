"""The dense rows render against the JAX package on the CPU:
``AnimNeRFSystem.render`` (perturb 0), ``make_eval_step`` and the
renderer's dense route (``Renderer(compact_samples=False)``), each with
``knn_far_skip`` off and on, in f32 and bf16.

The tiny rig of ``tests/test_rows_pipeline.py`` (V=128, J=12, 8 + 4
samples), its field at random weights with both sigma heads' biases
raised by 30, so that the 0.2 m shell is opaque, as a trained body is
(``chip_smoke.py::opaque_shell``): a nearly transparent field's tiny
composite weights make the fine pass's CDF inversion amplify f32 rounding
(a 1e-6 difference in a coarse weight of 1e-3 moves a fine depth by
1e-4), which no implementation of it escapes. The JAX side takes its
rows path with every Pallas kernel in interpret mode
(``rows_interpret_forced``, ``fused_mlp="on"``) and turns the skip on by
replacing the scene config; the port runs its kernels' plain versions.
The first half of the rays miss the body by far, so whole 1024-point kNN
groups are background and skip, and the second half hit it, so the
others sweep: both branches run (asserted on the captured kNN calls).

Tolerances: atol 1e-4 in f32 (the f32 MLP's sums in another order),
2e-2 in bf16 (a bf16 rounding of an activation may flip; see
``tests/test_torch_render.py``), depths 5x that (depth ~ 3 x alpha). The
port's own outputs with the skip on and off are bit-equal: skipped points
lie outside the shell, where the warp's validity test gives the
outside-shell sigma and a composite weight of exactly 0.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

R = 256  # rays: coarse 2048 points (2 kNN groups), fine 1024 (1 group)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _rays(B: int, seed: int) -> np.ndarray:
    """(B, R, 8) world rays from (0, 0, 3): the first R/2 aimed 2-3 m off
    the body's axis (every sample far from every vertex), the rest at
    it."""
    rng = np.random.default_rng(seed)
    o = np.zeros((B, R, 3), np.float32)
    o[..., 2] = 3.0
    tgt = rng.normal(scale=0.15, size=(B, R, 3))
    h = R // 2
    ang = rng.uniform(0, 2 * np.pi, size=(B, h))
    rad = rng.uniform(2.0, 3.0, size=(B, h))
    tgt[:, :h, 0] = rad * np.cos(ang)
    tgt[:, :h, 1] = rad * np.sin(ang)
    tgt[..., 2] = 0.0
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nf = np.broadcast_to(np.array([0.1, 10.0], np.float32), (B, R, 2))
    return np.concatenate([o, d, nf], -1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_setup(dtype: str):
    from __graft_entry__ import _flagship_system
    from animnerf_tpu.models.body_params import init_body_params
    from animnerf_tpu.training.system import AnimNeRFSystem

    cfg, system, params_for, J = _flagship_system(tiny=True)
    cfg.compute_dtype = dtype
    cfg.fused_mlp = "on"
    cfg.pose_dim = 3 * (J - 1)
    system = AnimNeRFSystem(cfg, system.body_model)
    params = system.init_params(jax.random.PRNGKey(0), init_body_params(
        cfg.num_frames, pose_dim=3 * (J - 1)))
    for net in ("nerf", "nerf_fine"):  # an opaque shell
        sig = params["anim_nerf"][net]["params"]["sigma"]
        sig["bias"] = sig["bias"] + 30.0
    # stored per-frame params that differ from the batch's
    stored = {k: np.asarray(v) for k, v in params_for(5, cfg.num_frames)
              .items()}
    stored["betas"] = stored["betas"][:1]
    params["body_params"] = {k: jnp.asarray(v) for k, v in stored.items()}
    bp = {k: np.asarray(v) for k, v in params_for(1, 2).items()}
    tmpl = {k: np.asarray(v) for k, v in params_for(2, 2).items()}
    tmpl["transl"] = np.zeros_like(tmpl["transl"])
    return cfg, system, params, bp, tmpl


def _far_skip_jax(system, on: bool):
    system.scene.cfg = dataclasses.replace(system.scene.cfg,
                                           knn_far_skip=on)
    system.scene_cfg = system.scene.cfg


def _run_jax(dtype: str, far_skip: bool, fn):
    """fn(cfg, system, params, bp, tmpl) on the JAX rows path, kernels in
    interpret mode, bf16 dots through the f32 shim of
    tests/test_torch_render.py."""
    import animnerf_tpu.ops.fused_mlp as FM
    from animnerf_tpu.utils.interpret import rows_interpret_forced

    cfg, system, params, bp, tmpl = _jax_setup(dtype)
    _far_skip_jax(system, far_skip)
    dot = FM._dot
    FM._dot = lambda wt, h: dot(wt.astype(jnp.float32), h.astype(jnp.float32))
    try:
        with rows_interpret_forced():
            assert system.rows_renderable()
            out = fn(cfg, system, params, bp, tmpl)
            return jax.tree.map(np.asarray, out)
    finally:
        FM._dot = dot
        _far_skip_jax(system, False)
        jax.clear_caches()


def _port_system(dtype: str, far_skip: bool):
    from animnerf_tpu_torch.data.synthetic import make_body_model
    from animnerf_tpu_torch.system import AnimNeRFSystem
    from animnerf_tpu_torch.utils.convert import nerf_params_from_flax

    cfg, _, params, _, _ = _jax_setup(dtype)
    system = AnimNeRFSystem(cfg, make_body_model(128, 12, seed=0),
                            device="cpu")
    an = jax.tree.map(np.asarray, params["anim_nerf"])
    system.load_anim_nerf({k: nerf_params_from_flax(v)
                           for k, v in an.items()})
    with torch.no_grad():
        for k, v in params["body_params"].items():
            system.body_params[k].copy_(torch.tensor(np.asarray(v)))
    system.scene_cfg = dataclasses.replace(system.scene_cfg,
                                           knn_far_skip=far_skip)
    system.scene.cfg = system.scene_cfg
    return system


def _captured_knn(fn):
    """Run fn with the warp's kNN entry wrapped: the skip decisions
    (``far_groups_plain``) of each call made with far_skip > 0."""
    from animnerf_tpu_torch.models import warp
    from animnerf_tpu_torch.ops.knn_kernel import far_groups_plain

    orig, skips = warp.knn, []

    def record(points, verts, k=4, **kw):
        if kw.get("far_skip", 0.0) > 0:
            skips.append(far_groups_plain(points, verts, kw["far_skip"])[1])
        return orig(points, verts, k, **kw)

    warp.knn = record
    try:
        out = fn()
    finally:
        warp.knn = orig
    return out, skips


def _assert_both_branches(skips):
    """The coarse call skipped some groups and swept others."""
    assert skips, "no kNN call with the far skip"
    assert skips[0].any() and not skips[0].all(), skips[0]


def _t(d: dict) -> dict:
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


def _compare(port: dict, ref: dict, atol: float):
    assert set(port) == set(ref)
    for k in ref:
        tol = 5 * atol if k.startswith("depths") else atol
        np.testing.assert_allclose(port[k], ref[k], atol=tol, err_msg=k)


DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("far_skip", [False, True])
def test_system_render_matches_jax(dtype, far_skip):
    rays = _rays(2, seed=0)
    ref = _run_jax(dtype, far_skip, lambda cfg, s, p, bp, tm: s.render(
        p, {k: jnp.asarray(v) for k, v in bp.items()},
        {k: jnp.asarray(v) for k, v in tm.items()}, jnp.asarray(rays),
        perturb=0.0)[0])
    _, _, _, bp, tmpl = _jax_setup(dtype)
    outs = {}
    for on in (False, True):
        system = _port_system(dtype, on)
        with torch.no_grad():
            (out, _), skips = _captured_knn(lambda: system.render(
                _t(bp), _t(tmpl), torch.from_numpy(rays)))
        outs[on] = {k: v.numpy() for k, v in out.items()}
        if on:
            _assert_both_branches(skips)
    assert set(outs[True]) == {"rgbs", "alphas", "depths", "rgbs_fine",
                               "alphas_fine", "depths_fine"}
    for k in outs[True]:
        np.testing.assert_array_equal(outs[True][k], outs[False][k], k)
    _compare(outs[far_skip], ref, TOL[dtype])


def _eval_batch(bp: dict, tmpl: dict) -> dict:
    """Two rays batches: frame 3 (stored params) and frame -1 (given)."""
    return {"frame_idx": np.array([3, -1], np.int32),
            "rays": _rays(2, seed=1), **bp,
            **{k + "_template": v for k, v in tmpl.items()}}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("far_skip", [False, True])
def test_eval_step_matches_jax(dtype, far_skip):
    from animnerf_tpu_torch.training.system import make_eval_step

    _, _, _, bp, tmpl = _jax_setup(dtype)
    batch = _eval_batch(bp, tmpl)
    ref = _run_jax(dtype, far_skip,
                   lambda cfg, s, p, bp, tm: s.make_eval_step()(
                       p, {k: jnp.asarray(v) for k, v in batch.items()}))
    outs = {}
    for on in (False, True):
        step = make_eval_step(_port_system(dtype, on))
        out, skips = _captured_knn(lambda: step(_t(batch)))
        outs[on] = {k: v.numpy() for k, v in out.items()}
        if on:
            _assert_both_branches(skips)
    for k in outs[True]:
        np.testing.assert_array_equal(outs[True][k], outs[False][k], k)
    _compare(outs[far_skip], ref, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("far_skip", [False, True])
def test_dense_renderer_matches_jax(dtype, far_skip):
    """The port's Renderer(compact_samples=False) frame against JAX's
    dense render_frame (compact_samples off, no ray cull below its 32768
    rays); the port once more with 128-ray slabs and the ray cull, which
    is exact."""
    from animnerf_tpu_torch.render.inference import Renderer

    rays = _rays(1, seed=2)[0]

    def jax_frame(cfg, s, p, bp, tm):
        from animnerf_tpu.render.inference import Renderer as JaxRenderer

        r = JaxRenderer(s)
        r.compact_samples = False
        return r.render_frame(
            p, {k: jnp.asarray(v[:1]) for k, v in bp.items()},
            {k: jnp.asarray(v[:1]) for k, v in tm.items()}, rays)

    ref = _run_jax(dtype, far_skip, jax_frame)
    _, _, _, bp, tmpl = _jax_setup(dtype)
    bp1 = {k: v[:1] for k, v in bp.items()}
    tm1 = {k: v[:1] for k, v in tmpl.items()}
    outs = {}
    for on in (False, True):
        r = Renderer(_port_system(dtype, on), device="cpu",
                     compact_samples=False)
        outs[on], skips = _captured_knn(
            lambda: r.render_frame(bp1, tm1, rays))
        assert r.last_counts == (R * 8, R * 4)
        if on:
            _assert_both_branches(skips)
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(a, b)
    atol = TOL[dtype]
    for got, want, tol in zip(outs[far_skip], ref, (atol, atol, 5 * atol)):
        np.testing.assert_allclose(got, want, atol=tol)
    assert (ref[1] > 0.5).any() and (ref[1] < 1e-3).any()

    r = Renderer(_port_system(dtype, far_skip), device="cpu",
                 compact_samples=False)
    r.max_rays_per_call = 128  # the ray cull, then 128-ray slabs
    culled = r.render_frame(bp1, tm1, rays)
    assert r.last_counts[0] < R * 8  # the cull dropped rays
    for got, want, tol in zip(culled, ref, (atol, atol, 5 * atol)):
        np.testing.assert_allclose(got, want, atol=tol)


def test_render_rejects_what_the_rows_render_does_not_cover():
    """The rows render itself takes up to 128 samples a ray and needs the
    training noise at perturb > 0; a config of more samples is not rows
    renderable, and the system renders it through the split renderer (the
    JAX package's route) instead of raising."""
    from animnerf_tpu_torch.data.synthetic import make_body_model
    from animnerf_tpu_torch.render.volume_renderer import render_rays_rows
    from animnerf_tpu_torch.system import AnimNeRFSystem

    bp = {k: torch.tensor(v[:1])
          for k, v in _jax_setup("float32")[3].items()}
    rays = torch.from_numpy(_rays(1, seed=3)[:, :4])
    system = _port_system("float32", False)
    with pytest.raises(ValueError, match="noise"):
        system.render(bp, bp, rays, perturb=1.0)
    wide = AnimNeRFSystem({"n_samples": 100, "n_importance": 32,
                           "pose_dim": 33}, make_body_model(128, 12, seed=0),
                          device="cpu")
    assert not wide.rows_renderable()
    with pytest.raises(NotImplementedError, match="128"):
        render_rays_rows(wide.renderer_cfg, lambda r: r,
                         lambda r, f: r, rays)
    with torch.no_grad():
        out, _ = wide.render(bp, bp, rays)
    assert out["rgbs_fine"].shape == (1, 4, 3)
    assert all(torch.isfinite(v).all() for v in out.values())


def test_compacted_and_dense_renderers_agree():
    """The compacted route and the dense route give the same frame (both
    exact: dropped samples composite with weight 0), with the skip on."""
    from animnerf_tpu_torch.render.inference import Renderer

    _, _, _, bp, tmpl = _jax_setup("float32")
    bp1 = {k: v[:1] for k, v in bp.items()}
    tm1 = {k: v[:1] for k, v in tmpl.items()}
    rays = _rays(1, seed=2)[0]
    system = _port_system("float32", True)
    dense = Renderer(system, device="cpu", compact_samples=False)
    comp = Renderer(system, device="cpu")
    for a, b in zip(dense.render_frame(bp1, tm1, rays),
                    comp.render_frame(bp1, tm1, rays)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert comp.last_counts[0] < dense.last_counts[0]
