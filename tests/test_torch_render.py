"""The port's renderer pieces and the whole compacted novel-view render
against the JAX package, on the CPU.

The JAX side reaches its Pallas kernels in interpret mode
(``rows_interpret_forced`` with ``fused_mlp="on"``); the port runs its
kernels' plain versions (``device="cpu"``). Inputs come from numpy seeds
and go through both packages.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import animnerf_tpu.render.volume_renderer as JV
from animnerf_tpu.render import compact as JC
from animnerf_tpu_torch.render import compact as TC
from animnerf_tpu_torch.render import volume_renderer as TV

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "docs", "demo",
                    "scale512", "ckpt")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rays(rng, R):
    o = rng.normal(scale=0.2, size=(1, R, 3)).astype(np.float32)
    o[..., 2] += 3.0
    d = -o + rng.normal(scale=0.1, size=o.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nf = np.stack([np.full((1, R), 2.0), np.full((1, R), 4.0)],
                  -1).astype(np.float32)
    return np.concatenate([o, d, nf], -1)


@pytest.mark.parametrize("K", [8, 64])
def test_sample_coarse_matches(K):
    rays = _rays(np.random.default_rng(0), 50)
    cfg = JV.RendererConfig(n_coarse=K)
    a = np.asarray(JV.sample_coarse(cfg, jnp.asarray(rays), 0.0, None))
    b = TV.sample_coarse(TV.RendererConfig(n_coarse=K), _t(rays)).numpy()
    np.testing.assert_array_equal(a, b)  # same f32 arithmetic, bit for bit


@pytest.mark.parametrize("Kc,Kf", [(8, 4), (64, 32)])
def test_sample_fine_det_matches(Kc, Kf):
    rng = np.random.default_rng(1)
    z = np.sort(rng.uniform(2, 4, size=(1, 40, Kc)), -1).astype(np.float32)
    mids = 0.5 * (z[..., :-1] + z[..., 1:])
    w = rng.random((1, 40, Kc - 2)).astype(np.float32) ** 4
    a = np.asarray(JV.sample_fine(JV.RendererConfig(n_coarse=Kc, n_fine=Kf),
                                  jnp.asarray(mids), jnp.asarray(w),
                                  det=True, key=None))
    b = TV.sample_fine(TV.RendererConfig(n_coarse=Kc, n_fine=Kf), _t(mids),
                       _t(w)).numpy()
    # The CDF's f32 sums run in another order (XLA rewrites the cumsum
    # into a blocked scan), so a u within a few ulps of a CDF knot (u = 1
    # against cdf[-1] = 1 +- ulp, typically) may pick the neighbouring
    # bin there; such samples stay within one bin width. Elsewhere the
    # depths (O(1)) agree to f32 rounding.
    wd = w.astype(np.float64) + 1e-5
    cdf = np.concatenate([np.zeros((1, 40, 1)),
                          np.cumsum(wd / wd.sum(-1, keepdims=True), -1)], -1)
    u = np.linspace(0.0, 1.0, Kf)
    # cdf[0] == 0 exactly on both sides: only the summed knots count
    knot = (np.abs(cdf[..., None, 1:] - u[:, None]) < 1e-6).any(-1)
    np.testing.assert_allclose(a[~knot], b[~knot], atol=1e-5)
    width = np.diff(mids, axis=-1).max()
    assert np.abs(a[knot] - b[knot]).max(initial=0.0) <= width
    assert knot[..., :-1].mean() < 0.05  # mostly the u = 1 column


def test_sample_fine_rejects_rows_wider_than_the_lanes():
    """The lane gather holds 128 lanes and raises on wider rows; so
    sample_fine picks by width, as the JAX package picks gather_lanes or
    take_along_axis: wider rows take torch.gather and give JAX's
    deterministic fine depths (f32 rounding only, atol 1e-5)."""
    from animnerf_tpu_torch.ops.sort_lanes import gather_lanes

    Kc = 200
    z = np.sort(np.random.default_rng(1).uniform(2, 4, size=(1, 3, Kc)),
                -1).astype(np.float32)
    mids = 0.5 * (z[..., :-1] + z[..., 1:])
    w = np.random.default_rng(2).uniform(size=(1, 3, Kc - 2)).astype(
        np.float32)
    pay = torch.zeros((1, 2, 3, Kc - 1))
    with pytest.raises(ValueError, match="128"):
        gather_lanes(pay, torch.zeros((1, 3, 32), dtype=torch.int32))
    got = TV.sample_fine(TV.RendererConfig(n_coarse=Kc, n_fine=32),
                         _t(mids), _t(w))
    want = JV.sample_fine(JV.RendererConfig(n_coarse=Kc, n_fine=32),
                          jnp.asarray(mids), jnp.asarray(w), det=True,
                          key=None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_composite_functions_match():
    rng = np.random.default_rng(2)
    rays = _rays(rng, 30)
    z = np.sort(rng.uniform(2, 4, size=(1, 30, 16)), -1).astype(np.float32)
    sig = rng.normal(scale=5, size=(1, 30, 16)).astype(np.float32)
    rgb = rng.random((1, 30, 16, 3)).astype(np.float32)
    jcfg, tcfg = JV.RendererConfig(), TV.RendererConfig()
    ja = JV.composite(jcfg, jnp.asarray(rgb), jnp.asarray(sig),
                      jnp.asarray(rays), jnp.asarray(z), 0.0, None)
    ta = TV.composite(tcfg, _t(rgb), _t(sig), _t(rays), _t(z))
    frows = np.concatenate([np.moveaxis(rgb, -1, 1), sig[:, None]], 1)
    jr = JV.composite_rows(jcfg, jnp.asarray(frows), jnp.asarray(rays),
                           jnp.asarray(z), 0.0, None)
    tr = TV.composite_rows(tcfg, _t(frows), _t(rays), _t(z))
    for j, t in list(zip(ja, ta)) + list(zip(jr, tr)):
        # exp and cumprod order: f32 rounding on O(1) values
        np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=1e-5)


def test_select_indices_matches():
    keep = np.random.default_rng(3).random((2, 300)) < 0.2
    for cap in (10, 80, 400):
        a = np.asarray(JC.select_indices(jnp.asarray(keep), cap))
        b = TC.select_indices(_t(keep), cap).numpy()
        np.testing.assert_array_equal(a, b)
    b = TC.select_indices(_t(keep[:1])).numpy()
    np.testing.assert_array_equal(b[0], np.nonzero(keep[0])[0])


# ------------------------------------------------------------ whole slice


def rigid_lbs_jax(body_model, J):
    """The rig with one-hot LBS weights (the largest entry of each row):
    neighbours on one bone then pass the warp's confidence gate together,
    where the seeded rig's weights keep only neighbour 0."""
    return body_model.replace(lbs_weights=jnp.eye(J, dtype=jnp.float32)[
        jnp.argmax(body_model.lbs_weights, axis=1)])


def rigid_lbs_torch(body_model, J):
    body_model.lbs_weights = torch.nn.functional.one_hot(
        body_model.lbs_weights.argmax(1), J).float()
    return body_model


def _jax_frame(compute_dtype, H, W, k_neigh=4, rigid=False):
    from __graft_entry__ import _flagship_system
    from animnerf_tpu.models.body_params import init_body_params
    from animnerf_tpu.ops.ray_utils import camera_to_c2w, gen_rays
    from animnerf_tpu.render.inference import Renderer
    from animnerf_tpu.training.system import AnimNeRFSystem
    from animnerf_tpu.utils.interpret import rows_interpret_forced

    cfg, system, params_for, J = _flagship_system(tiny=True)
    cfg.compute_dtype = compute_dtype
    cfg.fused_mlp = "on"
    cfg.k_neigh = k_neigh
    system = AnimNeRFSystem(cfg, rigid_lbs_jax(system.body_model, J)
                            if rigid else system.body_model)
    params = system.init_params(jax.random.PRNGKey(0),
                                init_body_params(cfg.num_frames,
                                                 pose_dim=3 * (J - 1)))
    bp = {k: np.asarray(v) for k, v in params_for(1, 1).items()}
    tmpl = {k: np.asarray(v) for k, v in params_for(2, 1).items()}
    tmpl["transl"] = np.zeros_like(tmpl["transl"])
    f = 1.2 * W
    c2w = camera_to_c2w(np.eye(3), np.array([0.0, 0.0, 3.0]))
    rays = gen_rays(c2w, H, W, [f, f], 0.1, 10.0).reshape(-1, 8)
    import animnerf_tpu.ops.fused_mlp as FM

    # XLA:CPU's compiled dot lacks bf16 x bf16 -> f32 (the JAX package's
    # own bf16 kernel test runs eagerly instead, which takes ~30 s here):
    # feed the kernel's dots the same bf16 values as f32 operands, which
    # gives the same exact products with f32 accumulation
    dot = FM._dot
    FM._dot = lambda wt, h: dot(wt.astype(jnp.float32), h.astype(jnp.float32))
    try:
        with rows_interpret_forced():
            r = Renderer(system)
            r.compact_quantum = 256
            out = r.render_frame(
                params, {k: jnp.asarray(v) for k, v in bp.items()},
                {k: jnp.asarray(v) for k, v in tmpl.items()}, rays)
            out = [np.asarray(o) for o in out]
    finally:
        FM._dot = dot
        jax.clear_caches()
    return cfg, params, bp, tmpl, rays, out


@pytest.mark.parametrize("compute_dtype,atol", [
    ("float32", 1e-4),
    # bf16: both sides round at the same points, but f32 accumulation
    # order differs (XLA dot vs an f32 matmul of bf16 values), which can
    # flip a bf16 rounding of an activation; such flips move a pixel by
    # at most a few bf16 ulps of the field's output
    ("bfloat16", 2e-2),
])
def test_render_frame_matches_jax(compute_dtype, atol):
    from animnerf_tpu_torch.data.synthetic import make_body_model
    from animnerf_tpu_torch.render.inference import Renderer
    from animnerf_tpu_torch.system import AnimNeRFSystem
    from animnerf_tpu_torch.utils.convert import nerf_params_from_flax

    cfg, params, bp, tmpl, rays, (img_j, mask_j, depth_j) = _jax_frame(
        compute_dtype, 16, 16)
    system = AnimNeRFSystem(cfg, make_body_model(128, 12, seed=0),
                            device="cpu")
    an = jax.tree.map(np.asarray, params["anim_nerf"])
    system.load_anim_nerf({k: nerf_params_from_flax(v)
                           for k, v in an.items()})
    r = Renderer(system, device="cpu")
    img, mask, depth = r.render_frame(bp, tmpl, rays)
    n_c, n_f = r.last_counts
    assert n_c > 0 and n_f > 0, "the frame must have survivors"
    assert (mask > 1e-3).any(), "the body must be visible"
    np.testing.assert_allclose(img, img_j, atol=atol)
    np.testing.assert_allclose(mask, mask_j, atol=atol)
    # depth = sum(w z) + (1 - sum w) far, z ~ 3: scale the bound
    np.testing.assert_allclose(depth, depth_j, atol=5 * atol)


def test_load_checkpoint_matches_jax_load_params():
    from animnerf_tpu.models.body_params import init_body_params
    from animnerf_tpu.models.nerf import NeRFMLP as FlaxNeRF
    from animnerf_tpu.training.checkpoints import load_params
    from animnerf_tpu_torch.utils.convert import (
        load_checkpoint,
        nerf_params_from_flax,
    )

    ck = load_checkpoint(CKPT)
    mod = FlaxNeRF(freqs_xyz=10, freqs_dir=4, use_view=False)
    init = mod.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))
    target = {"anim_nerf": {"nerf": init, "nerf_fine": init},
              "body_params": init_body_params(4, pose_dim=69)}
    ref = load_params(CKPT, target, ["anim_nerf", "body_params"])
    assert ck["cfg"]["freqs_xyz"] == 10 and ck["cfg"]["n_importance"] == 32
    for net in ("nerf", "nerf_fine"):
        want = nerf_params_from_flax(jax.tree.map(np.asarray,
                                                  ref["anim_nerf"][net]))
        got = ck["anim_nerf"][net]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    for k, v in ref["body_params"].items():
        np.testing.assert_array_equal(ck["body_params"][k], np.asarray(v))
