"""A 3-step SGD-momentum trajectory of the port's RowsCompactTrainer
against the JAX package's, on the CPU (as tests/test_compact_rows.py:184
holds the JAX engines against each other: SGD, because Adam amplifies
reduction-order noise on near-zero gradients)."""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_parallel import _tiny_setup  # noqa: E402
from test_rows_pipeline import rows_path_forced  # noqa: E402
from test_torch_train import _check_params, jax_noise, port_system  # noqa: E402

from animnerf_tpu.models.body_params import init_body_params  # noqa: E402
from animnerf_tpu.training.system import AnimNeRFSystem  # noqa: E402
from animnerf_tpu_torch.training import system as TS  # noqa: E402

torch.set_num_threads(1)


def test_sgd_trajectory_matches_jax_trainer(monkeypatch):
    """Loss of the third step within rtol 5e-5 and every parameter within
    rtol 1e-4 / atol 1e-6 after three steps (the JAX package's own bounds
    for its compacted vs dense trainers); the noise of step s is drawn
    along the JAX key path fold_in(key, s)."""
    monkeypatch.setenv("ANIMNERF_MORTON_COMPACT", "1")
    B, R = 2, 16
    cfg, system, nj, batch = _tiny_setup(seed=0, B=B, n_rays=R)
    cfg.train.optimizer.type = "sgd"
    cfg.train.optimizer.momentum = 0.9
    system = AnimNeRFSystem(cfg, system.body_model)
    state = system.init_state(
        jax.random.PRNGKey(0),
        init_body_params(cfg.num_frames, pose_dim=3 * (nj - 1)),
        steps_per_epoch=10)
    tx = system.make_optimizer(steps_per_epoch=10)
    key = jax.random.PRNGKey(7)
    port = port_system(cfg, nj, state.params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with rows_path_forced():
        system.scene.__dict__["use_fused_mlp"] = True
        trainer = system.make_rows_compact_trainer(tx, quantum=32)
        st = state
        for _ in range(3):
            st, jd = trainer.step(st, jb, key)
    jax.clear_caches()

    tt = TS.RowsCompactTrainer(port, steps_per_epoch=10)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    for s in range(3):
        td = tt.step(tb, jax_noise(key, s, B, R, cfg.n_samples,
                                   cfg.n_importance, 128))
    np.testing.assert_allclose(float(td["loss"]), float(jd["loss"]),
                               rtol=5e-5)
    _check_params(port, st.params, atol=1e-6, rtol=1e-4)
