"""The dense training engine and what it trains, against the JAX package
on the CPU: three ``DenseTrainer`` steps against JAX ``make_train_step``
(view directions warped with the points, latent codes, DeRF; SGD with
momentum, the JAX noise passed in), the engine ``fit`` picks and a
``fit`` of a view config on a synthetic dataset followed by the test CLI,
whose scores JAX ``evaluate`` gives too, and a checkpoint with latent
codes and DeRF saved, reloaded bit for bit and read by the JAX loader.

The step's rig and tolerances are ``tests/test_torch_split_render.py``'s
(4 encoding frequencies, the JAX warp in interpret mode); the parameters
after three steps within atol 1e-6 (SGD: lr times gradients within the
2e-3 bound); PSNR / SSIM within 1e-4 as ``tests/test_torch_loop.py``.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_loop import _jax_cfg, _port_cfg  # noqa: E402
from test_torch_split_render import (  # noqa: E402
    FREQS_XYZ,
    jax_noise,
    port_system,
)
from test_parallel import _tiny_setup  # noqa: E402

from animnerf_tpu.data.synthetic import write_synthetic_dataset  # noqa: E402
from animnerf_tpu.models.body_params import init_body_params  # noqa: E402
from animnerf_tpu.utils import rng as prng  # noqa: E402
from animnerf_tpu.utils.interpret import rows_interpret_forced  # noqa: E402
from animnerf_tpu_torch.training import loop as TL  # noqa: E402
from animnerf_tpu_torch.training import system as TS  # noqa: E402
from animnerf_tpu_torch.utils.convert import net_params_from_flax  # noqa: E402

torch.set_num_threads(1)

B, R, STEPS, KEY = 2, 16, 3, 7
STEP_CFG = dict(use_view=True, freqs_dir=4, unpose_view=True,
                use_deformation=True, deformation_dim=4, apperance_dim=3)
VIEW_OPTS = ["use_view", "True", "freqs_dir", "4", "unpose_view", "True"]


def test_dense_trainer_steps_match_jax_train_step():
    """Parameters (fields, DeRF, latent codes, body params) after three
    steps on three batches, and each step's loss."""
    from animnerf_tpu.training.system import AnimNeRFSystem as JSys

    cfg, system, nj, _ = _tiny_setup(seed=0, B=B, n_rays=R)
    cfg.freqs_xyz = FREQS_XYZ
    for k, v in STEP_CFG.items():
        cfg[k] = v
    cfg.train.optimizer.type = "sgd"
    jsys = JSys(cfg, system.body_model)
    state = jsys.init_state(jax.random.PRNGKey(0), init_body_params(
        cfg.num_frames, pose_dim=3 * (nj - 1)), steps_per_epoch=10)
    tx = jsys.make_optimizer(steps_per_epoch=10)
    batches = [_tiny_setup(seed=s, B=B, n_rays=R)[3] for s in range(STEPS)]
    ref = dict(cfg=cfg, nj=nj, params=jax.tree.map(np.asarray,
                                                   state.params))
    port = port_system(ref)
    assert not TS.rows_compaction_applicable(port)
    trainer = TS.make_trainer(port, steps_per_epoch=10)
    assert isinstance(trainer, TS.DenseTrainer) and trainer.engine == "dense"
    key = jax.random.PRNGKey(KEY)
    with rows_interpret_forced():
        step = jax.jit(jsys.make_train_step(tx))
        for i, b in enumerate(batches):
            state, jd = step(state, {k: jnp.asarray(v)
                                     for k, v in b.items()}, key)
            noise = jax_noise(prng.elem_keys(jax.random.fold_in(key, i), B),
                              B, R, cfg.n_samples, cfg.n_importance, 0, 128)
            td = trainer.step({k: torch.from_numpy(np.asarray(v))
                               for k, v in b.items()}, noise)
            np.testing.assert_allclose(float(td["loss"]), float(jd["loss"]),
                                       rtol=2e-3)
    jax.clear_caches()
    jp = jax.tree.map(np.asarray, state.params)
    for net, flat in jp["anim_nerf"].items():
        want = net_params_from_flax(net, flat)
        for name, p in getattr(port.scene, net).named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       atol=1e-6, err_msg=f"{net}.{name}")
    for k, v in jp["body_params"].items():
        np.testing.assert_allclose(port.body_params[k].detach().numpy(), v,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(port.latent_codes.detach().numpy(),
                               jp["latent_codes"], atol=1e-6)
    moved = jp["latent_codes"] - np.asarray(ref["params"]["latent_codes"])
    assert np.abs(moved).max() > 0


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ds"))
    write_synthetic_dataset(root, num_frames=4, img_wh=(16, 16),
                            num_verts=128, num_joints=8, seed=7)
    return root


def test_fit_picks_the_engine_as_jax_does(root, tmp_path, capsys):
    """The rows engine for the flagship, the dense one otherwise (view
    directions, more than 128 samples a ray), named on a line."""
    for opts, engine in (([], "rows"), (VIEW_OPTS, "dense"),
                         (["n_samples", "100", "n_importance", "40"],
                          "dense")):
        cfg = _port_cfg(root, str(tmp_path), "e" + engine,
                        "train.max_steps", "1", *opts)
        system = TL.build_system(cfg, "cpu")
        trainer = TS.make_trainer(system)
        assert trainer.engine == engine, opts
    TL.fit(_port_cfg(root, str(tmp_path), "wide", "train.max_steps", "1",
                     "n_samples", "100", "n_importance", "40"),
           device="cpu")
    assert "trainer engine: dense" in capsys.readouterr().out


def test_fit_view_config_then_test_cli(root, tmp_path, capsys):
    """fit with view directions warped with the points, then the test CLI
    on its last: JAX evaluate gives the same PSNR and SSIM on it."""
    from animnerf_tpu.training.loop import evaluate as jax_evaluate
    from animnerf_tpu_torch.cli import test as test_cli

    cfg = _port_cfg(root, str(tmp_path), "view", *VIEW_OPTS)
    ckpt_dir = TL.fit(cfg, device="cpu")
    assert "trainer engine: dense" in capsys.readouterr().out
    last = os.path.join(ckpt_dir, "last")
    means = test_cli.main(["--ckpt_path", last, "--device", "cpu"])
    assert all(np.isfinite(v) for v in means.values())
    jcfg = _jax_cfg(root, str(tmp_path), "view", *VIEW_OPTS)
    with rows_interpret_forced():
        want = jax_evaluate(jcfg, last)
    jax.clear_caches()
    for k in want:
        np.testing.assert_allclose(means[k], want[k], atol=1e-4, err_msg=k)


def test_checkpoint_with_codes_and_derf_roundtrips(root, tmp_path):
    """save_train_state of a system with latent codes and DeRF, loaded
    into a fresh system bit for bit; the JAX loader reads every array
    (the codes under the key "" of latent_codes.npz, DeRF under derf/)."""
    from animnerf_tpu.models.body_params import load_body_params_from_dataset
    from animnerf_tpu.training.checkpoints import load_params as jax_load
    from animnerf_tpu.training.loop import build_system as jax_build
    from animnerf_tpu_torch.models.body_params import (
        load_body_params_from_dataset as port_body,
    )
    from animnerf_tpu_torch.training.checkpoints import (
        load_params,
        save_train_state,
        system_params,
    )

    opts = ["use_deformation", "True", "deformation_dim", "4",
            "apperance_dim", "3", *VIEW_OPTS]
    cfg = _port_cfg(root, str(tmp_path), "codes", *opts)
    system = TL.build_system(cfg, "cpu")
    system.set_body_params(port_body(cfg.frame_IDs, root))
    opt, sched = TS.make_optimizer(system, 10)
    path = str(tmp_path / "last")
    save_train_state(path, system, opt, sched, 3)
    fresh = TL.build_system(_port_cfg(root, str(tmp_path), "codes2", *opts,
                                      "seed", "5"), "cpu")
    fresh.set_body_params(port_body(cfg.frame_IDs, root))
    assert not torch.equal(fresh.latent_codes, system.latent_codes)
    load_params(path, fresh)
    want = dict(system.named_parameters())
    got = dict(fresh.named_parameters())
    assert sorted(got) == sorted(want)
    assert any(k.startswith("scene.derf.") for k in got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k

    jcfg = _jax_cfg(root, str(tmp_path), "codes", *opts)
    jsys = jax_build(jcfg)
    params = jsys.init_params(jax.random.PRNGKey(1),
                              load_body_params_from_dataset(
                                  jcfg.frame_IDs, root))
    params = jax.tree.map(np.asarray, jax_load(path, params))
    mine = system_params(system)
    np.testing.assert_array_equal(params["latent_codes"],
                                  mine["latent_codes"][""])
    for key, v in mine["anim_nerf"].items():
        node = params["anim_nerf"]
        for p in key.split("/"):
            node = node[p]
        np.testing.assert_array_equal(np.asarray(node), v, err_msg=key)
    assert any(k.startswith("derf/") for k in mine["anim_nerf"])


def test_renderer_fails_on_latent_codes_as_jax_does(root, tmp_path):
    """The JAX package's Renderer passes no latent codes, and its field
    fails on the missing code; the port's Renderer raises for such a
    model (evaluate it through make_eval_step), and takes a view model."""
    from animnerf_tpu.models.body_params import load_body_params_from_dataset
    from animnerf_tpu.render.inference import Renderer as JRenderer
    from animnerf_tpu.training.loop import build_system as jax_build
    from animnerf_tpu_torch.render.inference import Renderer

    opts = ["deformation_dim", "4", "apperance_dim", "3"]
    jcfg = _jax_cfg(root, str(tmp_path), "codes", *opts)
    jsys = jax_build(jcfg)
    params = jsys.init_params(jax.random.PRNGKey(1),
                              load_body_params_from_dataset(
                                  jcfg.frame_IDs, root))
    bp = {k: np.asarray(v[:1]) for k, v in params["body_params"].items()}
    rays = np.tile(np.array([[0, 0, 3, 0, 0, -1, 0.1, 10]], np.float32),
                   (4, 1))
    with pytest.raises(TypeError, match="NoneType"):  # the missing code
        JRenderer(jsys).render_frame(params, bp, bp, rays)
    jax.clear_caches()
    system = TL.build_system(_port_cfg(root, str(tmp_path), "codes", *opts),
                             "cpu")
    with pytest.raises(TypeError, match="latent codes"):
        Renderer(system, device="cpu")
    Renderer(TL.build_system(_port_cfg(root, str(tmp_path), "v",
                                       *VIEW_OPTS), "cpu"), device="cpu")
