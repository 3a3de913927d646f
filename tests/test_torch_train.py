"""The port's training step against the JAX package, on the CPU.

The JAX twin runs ``AnimNeRFSystem.rows_compact_loss_fn`` with its
kernels in interpret mode (``rows_path_forced``, the fused MLP on, full
capacity, ``ANIMNERF_MORTON_COMPACT=1``) on ``tests/test_parallel.py``'s
tiny flagship setup; the port runs the kernels' plain versions from the
same parameters (``utils/convert.py::params_from_jax``) and the same noise,
drawn with ``jax.random`` along the JAX package's key path and passed in.
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

from test_parallel import _tiny_setup  # noqa: E402
from test_rows_pipeline import rows_path_forced  # noqa: E402

from animnerf_tpu.models.body_params import init_body_params  # noqa: E402
from animnerf_tpu.utils import rng as prng  # noqa: E402
from animnerf_tpu_torch.data.synthetic import make_body_model  # noqa: E402
from animnerf_tpu_torch.system import AnimNeRFSystem  # noqa: E402
from animnerf_tpu_torch.training import system as TS  # noqa: E402
from animnerf_tpu_torch.utils.convert import (  # noqa: E402
    nerf_params_from_flax,
    params_from_jax,
)
from animnerf_tpu_torch.utils.rng import TrainNoise  # noqa: E402

torch.set_num_threads(1)

B, R = 2, 16
KEY = 7


def jax_noise(key, step, B, R, Kc, Kf, V) -> TrainNoise:
    """The step's noise along the JAX key path: fold_in(key, step) ->
    elem_keys -> (k_render, k_loss); k_render -> (coarse, fine, sigma_c,
    sigma_f, depth); k_loss -> the two normal-loss jitters."""
    keys = prng.elem_keys(jax.random.fold_in(key, step), B)
    k_render, k_loss = prng.split_keys(keys, 2)
    kc, kf, knc, knf, _ = prng.split_keys(k_render, 5)
    k1, k2 = prng.split_keys(k_loss, 2)

    def t(a):
        return torch.from_numpy(np.array(a))

    return TrainNoise(t(prng.uniform(kc, (B, R, Kc))),
                      t(prng.uniform(kf, (B, R, Kf))),
                      t(prng.normal(knc, (B, R, Kc))),
                      t(prng.normal(knf, (B, R, Kc + Kf))),
                      t(prng.normal(k1, (B, V, 3))),
                      t(prng.normal(k2, (B, V, 3))))


def port_system(cfg, nj, params):
    system = AnimNeRFSystem(dict(cfg), make_body_model(128, nj, seed=0),
                            device="cpu")
    system.load_params(params_from_jax(jax.tree.map(np.asarray, params)))
    return system


@pytest.fixture(scope="module")
def ref():
    """One JAX value-and-grad of rows_compact_loss_fn (computed once)."""
    old = os.environ.get("ANIMNERF_MORTON_COMPACT")
    os.environ["ANIMNERF_MORTON_COMPACT"] = "1"
    try:
        cfg, system, nj, batch = _tiny_setup(seed=0, B=B, n_rays=R)
        state = system.init_state(
            jax.random.PRNGKey(0),
            init_body_params(cfg.num_frames, pose_dim=3 * (nj - 1)),
            steps_per_epoch=10)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        with rows_path_forced():
            system.scene.__dict__["use_fused_mlp"] = True
            (_, details), grads = jax.value_and_grad(
                partial(system.rows_compact_loss_fn,
                        cap_c=R * cfg.n_samples), has_aux=True)(
                state.params, jb, jax.random.PRNGKey(KEY), state.step)
    finally:
        if old is None:
            del os.environ["ANIMNERF_MORTON_COMPACT"]
        else:
            os.environ["ANIMNERF_MORTON_COMPACT"] = old
    jax.clear_caches()
    noise = jax_noise(jax.random.PRNGKey(KEY), 0, B, R, cfg.n_samples,
                      cfg.n_importance, 128)
    return dict(cfg=cfg, nj=nj, batch=batch, params=state.params,
                details=jax.tree.map(np.asarray, details),
                grads=jax.tree.map(np.asarray, grads), noise=noise)


@pytest.fixture(scope="module")
def port(ref):
    system = port_system(ref["cfg"], ref["nj"], ref["params"])
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
             ref["batch"].items()}
    loss, details = TS.rows_compact_loss_fn(system, batch, ref["noise"])
    loss.backward()
    return system, details


def test_rows_compact_details_match_jax(ref, port):
    """Every details entry, rtol 1e-5, except the normal terms (rtol 2e-3):
    they differentiate a 2^9-frequency encoding at jittered template
    vertices, which the two SMPL implementations compute to within ~1e-6
    (tests/test_torch_smpl.py), and that amplifies to ~1e-4 relative."""
    _, td = port
    jd = ref["details"]
    assert int(jd["compact_overflow"]) == 0
    for k, v in jd.items():
        if k == "compact_overflow":
            continue
        assert k in td, k
        tol = 2e-3 if k.startswith("loss_normals") or k == "loss" else 1e-5
        np.testing.assert_allclose(float(torch.as_tensor(td[k]).detach()),
                                   float(v), rtol=tol, err_msg=k)
    assert td["compact_count"] == int(jd["compact_count"])


def _rel_l2_ok(a, b, name):
    """tests/test_compact_rows.py:133-145's hybrid bound."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    num = float(np.linalg.norm((a - b).ravel()))
    den = float(np.linalg.norm(a.ravel()))
    if den < 1e-12:
        assert num < 1e-9, name
    else:
        assert num < 1e-8 or num / den < 2e-3, \
            f"grad rel-L2 {num / den:.2e} (abs {num:.2e}) at {name}"


def test_rows_compact_grads_match_jax(ref, port):
    """Every gradient leaf: the fields' kernels and biases and the body
    params (the hybrid rel-L2 bound of the JAX package's own compacted vs
    dense test); the body-pose gradient is nonzero."""
    system, _ = port
    g = ref["grads"]
    for net in ("nerf", "nerf_fine"):
        want = nerf_params_from_flax(g["anim_nerf"][net])
        mod = getattr(system.scene, net)
        for name, p in mod.named_parameters():
            _rel_l2_ok(want[name].numpy(), p.grad.numpy(), f"{net}.{name}")
    for k, v in g["body_params"].items():
        _rel_l2_ok(v, system.body_params[k].grad.numpy(), f"body.{k}")
    assert float(np.abs(g["body_params"]["body_pose"]).max()) > 0
    assert float(system.body_params["body_pose"].grad.abs().max()) > 0


def test_perturbed_sampling_and_noisy_composite_match_jax():
    """Stratified jitter, random-u importance sampling and the sigma-noise
    composite, given the JAX-drawn noise: same f32 arithmetic (atol 1e-6;
    1e-5 on depths for the CDF's scan order)."""
    import animnerf_tpu.render.volume_renderer as JV
    import animnerf_tpu_torch.render.volume_renderer as TV

    rng = np.random.default_rng(3)
    Bn, Rn, Kc, Kf = 2, 40, 16, 8
    o = rng.normal(scale=0.2, size=(Bn, Rn, 3)).astype(np.float32)
    o[..., 2] += 3.0
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True)
    rays = np.concatenate([o, d.astype(np.float32),
                           np.full((Bn, Rn, 1), 2.0, np.float32),
                           np.full((Bn, Rn, 1), 4.0, np.float32)], -1)
    key = jax.random.PRNGKey(11)
    kc, kf, kn = jax.random.split(key, 3)
    u_c = prng.uniform(kc, (Bn, Rn, Kc))
    u_f = prng.uniform(kf, (Bn, Rn, Kf))
    nz = prng.normal(kn, (Bn, Rn, Kc))
    jcfg = JV.RendererConfig(n_coarse=Kc, n_fine=Kf)
    tcfg = TV.RendererConfig(n_coarse=Kc, n_fine=Kf)
    jz = JV.sample_coarse(jcfg, jnp.asarray(rays), 1.0, kc)
    tz = TV.sample_coarse(tcfg, torch.from_numpy(rays), 1.0,
                          torch.from_numpy(np.array(u_c)))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-6)
    sig = rng.normal(scale=3.0, size=(Bn, Rn, Kc)).astype(np.float32)
    jw, jws = JV.composite_weights(jcfg, jnp.asarray(sig), jnp.asarray(rays),
                                   jz, 1.0, kn)
    tw, tws = TV.composite_weights(tcfg, torch.from_numpy(sig),
                                   torch.from_numpy(rays), tz,
                                   torch.from_numpy(np.array(nz)))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    mids = 0.5 * (jz[..., :-1] + jz[..., 1:])
    jf = JV.sample_fine(jcfg, mids, jw[..., 1:-1], det=False, key=kf)
    tf = TV.sample_fine(tcfg, torch.from_numpy(np.array(mids)),
                        torch.from_numpy(np.array(jw[..., 1:-1])),
                        u=torch.from_numpy(np.array(u_f)))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5)
    assert not tf.requires_grad


def _optax_and_port(ref, sgd: bool, steps_per_epoch: int):
    from animnerf_tpu.training.system import AnimNeRFSystem as JSys
    from animnerf_tpu.data.synthetic import make_body_model as j_make

    cfg = ref["cfg"].clone()
    if sgd:
        cfg.train.optimizer.type = "sgd"
        cfg.train.optimizer.momentum = 0.9
    jsys = JSys(cfg, j_make(num_verts=128, num_joints=ref["nj"], seed=0))
    tx = jsys.make_optimizer(steps_per_epoch=steps_per_epoch)
    system = port_system(cfg, ref["nj"], ref["params"])
    opt, sched = TS.make_optimizer(system, steps_per_epoch)
    return tx, system, opt, sched


def _set_grads(system, g):
    for net in ("nerf", "nerf_fine"):
        want = nerf_params_from_flax(g["anim_nerf"][net])
        for name, p in getattr(system.scene, net).named_parameters():
            p.grad = want[name].clone()
    for k, v in g["body_params"].items():
        system.body_params[k].grad = torch.from_numpy(np.array(v))


def _check_params(system, jparams, atol, rtol=0.0):
    for net in ("nerf", "nerf_fine"):
        want = nerf_params_from_flax(jax.tree.map(np.asarray,
                                                  jparams["anim_nerf"][net]))
        for name, p in getattr(system.scene, net).named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       atol=atol, rtol=rtol, err_msg=name)
    for k, v in jparams["body_params"].items():
        np.testing.assert_allclose(system.body_params[k].detach().numpy(),
                                   np.asarray(v), atol=atol, rtol=rtol,
                                   err_msg=k)


@pytest.mark.parametrize("sgd", [False, True])
def test_optimizer_updates_match_optax(ref, sgd):
    """Two updates on given gradients (one epoch per update, so the poly
    schedule decays between them) against the JAX package's optax
    transform: Adam (eps 1e-8) or SGD-momentum, the field at lr and the
    body params at 0.5 lr; parameters within 1e-6."""
    import optax

    tx, system, opt, sched = _optax_and_port(ref, sgd, steps_per_epoch=1)
    params = ref["params"]
    state = tx.init(params)
    rng = np.random.default_rng(6)
    for _ in range(2):
        g = jax.tree.map(lambda a: rng.normal(size=np.shape(a)).astype(
            np.float32), jax.tree.map(np.asarray, params))
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
        _set_grads(system, g)
        opt.step()
        sched.step()
    assert [grp["lr"] for grp in opt.param_groups][1] == pytest.approx(
        0.5 * opt.param_groups[0]["lr"])
    _check_params(system, params, atol=1e-6)


def test_trainer_step_selects_exactly(ref):
    """One RowsCompactTrainer step on the CPU: the survivor count is an
    exact int, no overflow flag exists, loss and gradients are finite and
    the parameters move."""
    system = port_system(ref["cfg"], ref["nj"], ref["params"])
    before = system.scene.nerf.xyz_0.weight.detach().clone()
    trainer = TS.RowsCompactTrainer(system, steps_per_epoch=10)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
             ref["batch"].items()}
    d = trainer.step(batch, ref["noise"])
    assert isinstance(d["compact_count"], int) and d["compact_count"] > 0
    assert "compact_overflow" not in d
    assert torch.isfinite(d["loss"])
    assert all(torch.isfinite(p.grad).all() for p in system.parameters()
               if p.grad is not None)
    assert not torch.equal(before, system.scene.nerf.xyz_0.weight)
