"""The port's synthetic rig, pickle loader and SMPL forward against the
JAX package, on the CPU."""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animnerf_tpu.data import synthetic as JS
from animnerf_tpu.smpl import body_model as JB
from animnerf_tpu_torch.data import synthetic as TS
from animnerf_tpu_torch.smpl import body_model as TB

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "docs", "demo",
                    "scale512", "ckpt")


@pytest.mark.parametrize("V,J,seed,surface", [
    (6890, 24, 3, False), (128, 12, 0, False), (300, 24, 5, True)])
def test_make_rig_bit_identical(V, J, seed, surface):
    a = JS.make_rig(V, J, seed=seed, surface=surface)
    b = TS.make_rig(V, J, seed=seed, surface=surface)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_make_body_model_matches():
    a = JS.make_body_model(num_verts=256, num_joints=24, seed=2)
    b = TS.make_body_model(num_verts=256, num_joints=24, seed=2)
    for k in ("v_template", "shapedirs", "posedirs", "J_regressor",
              "lbs_weights"):
        np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                      getattr(b, k).numpy())
    for k in ("parents", "faces", "extra_joint_idxs"):
        np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                      getattr(b, k))


def test_smpl_forward_matches_jax():
    jm = JS.make_body_model(num_verts=256, num_joints=24, seed=4)
    tm = TS.make_body_model(num_verts=256, num_joints=24, seed=4)
    p = JS.random_pose_params(24, batch=3, seed=7)
    ja = JB.forward(jm, **{k: jnp.asarray(v) for k, v in p.items()})
    ta = TB.forward(tm, **{k: torch.from_numpy(v) for k, v in p.items()})
    for k in ("vertices", "joints", "joints_transform", "vertices_transform",
              "shape_offsets", "pose_offsets"):
        # f32 FK chain of 4x4 products: rounding only
        np.testing.assert_allclose(getattr(ta, k).numpy(),
                                   np.asarray(getattr(ja, k)), atol=1e-5,
                                   err_msg=k)


def test_load_pickle_matches_jax_loader():
    from animnerf_tpu.smpl.loader import load_pickle as jload
    from animnerf_tpu_torch.smpl.loader import load_pickle as tload

    for name in ("smpl_000001.pkl", "smpl_template.pkl"):
        a = jload(os.path.join(CKPT, name))
        b = tload(os.path.join(CKPT, name))
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
