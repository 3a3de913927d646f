"""The port's SMPL-H / SMPL-X / MANO / FLAME rigs, forward and body params
against the JAX package, on the CPU."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animnerf_tpu.data import synthetic as JS
from animnerf_tpu.models import body_params as JP
from animnerf_tpu.smpl import body_model as JB
from animnerf_tpu_torch.data import synthetic as TS
from animnerf_tpu_torch.models import body_params as TP
from animnerf_tpu_torch.smpl import body_model as TB

torch.set_num_threads(1)

ARRAYS = ("v_template", "shapedirs", "posedirs", "J_regressor",
          "lbs_weights", "hand_components_l", "hand_components_r",
          "hand_mean_l", "hand_mean_r")
OUTPUTS = ("vertices", "joints", "joints_transform", "vertices_transform",
           "shape_offsets", "pose_offsets")


def _models(model_type, num_verts=200, seed=2, **kw):
    return (JS.make_body_model(num_verts, model_type=model_type, seed=seed,
                               **kw),
            TS.make_body_model(num_verts, model_type=model_type, seed=seed,
                               **kw))


def _params(model_type, B=3, seed=0):
    """Every body param of the family, from numpy."""
    rng = np.random.default_rng(seed)
    return {k: rng.normal(scale=0.3, size=(B, d)).astype(np.float32)
            for k, d in JP.PARAM_DIMS[model_type].items()}


@pytest.mark.parametrize("model_type", ["smplh", "smplx", "mano", "flame"])
def test_make_body_model_bit_identical(model_type):
    """Joint counts, rig arrays and hand PCA (num_pca, 45) / means (45,)
    from default_rng(seed + 77), bit for bit."""
    a, b = _models(model_type, num_pca=5)
    assert b.num_joints == JB.NUM_JOINTS[model_type] == a.num_joints
    assert TB.NUM_JOINTS == JB.NUM_JOINTS
    assert TB.NUM_BODY_JOINTS == JB.NUM_BODY_JOINTS
    for k in ARRAYS:
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert y.dtype == torch.float32
            np.testing.assert_array_equal(np.asarray(x), y.numpy(),
                                          err_msg=k)
    for k in ("parents", "faces", "extra_joint_idxs"):
        np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                      getattr(b, k))
    assert b.model_type == model_type and b.flat_hand_mean is False
    if model_type in ("smplh", "smplx"):
        assert tuple(b.hand_components_r.shape) == (5, 45)


@pytest.mark.parametrize("model_type,num_betas", [
    ("smplh", 10), ("smplx", 10), ("smplx", 20), ("mano", 10),
    ("flame", 10), ("flame", 20)])
def test_forward_matches_jax(model_type, num_betas):
    """forward against JAX bm.forward with every family parameter (hand
    PCA, jaw, neck, eyes; with num_betas=20 the expression moves the
    mesh through the fused shape + expression dirs): atol 1e-5, f32 FK
    chains of 4x4 products, rounding only."""
    a, b = _models(model_type, num_betas=num_betas, seed=4)
    p = _params(model_type, seed=7)
    if model_type == "flame":
        p.update(leye_pose=p["jaw_pose"][::-1].copy(),
                 reye_pose=p["neck_pose"][::-1].copy())
    ja = JB.forward(a, **{k: jnp.asarray(v) for k, v in p.items()})
    ta = TB.forward(b, **{k: torch.from_numpy(v) for k, v in p.items()})
    for k in OUTPUTS:
        np.testing.assert_allclose(getattr(ta, k).numpy(),
                                   np.asarray(getattr(ja, k)), atol=1e-5,
                                   err_msg=k)
    if "expression" in p and num_betas == 20:
        moved = TB.forward(b, **{k: torch.from_numpy(
            v + 1.0 if k == "expression" else v) for k, v in p.items()})
        assert not torch.allclose(moved.vertices, ta.vertices)


@pytest.mark.parametrize("model_type", ["smpl", "smplh"])
def test_rotation_matrix_forward_matches_jax(model_type):
    """pose2rot=False (rotation matrices, full-rotation hands) against the
    JAX package's, fed the same matrices: atol 1e-5."""
    from animnerf_tpu.smpl.lbs import rodrigues

    a, b = _models(model_type, seed=1)
    rng = np.random.default_rng(3)
    B = 2
    nb = b.num_joints - 1 if model_type == "smpl" else 21
    rot = {"global_orient": 1, "body_pose": nb}
    if model_type == "smplh":
        rot.update(left_hand_pose=15, right_hand_pose=15)
    p = {k: np.array(rodrigues(jnp.asarray(rng.normal(
        scale=0.3, size=(B, n, 3)).astype(np.float32)))).reshape(B, -1)
        for k, n in rot.items()}
    p["betas"] = rng.normal(scale=0.3, size=(B, 10)).astype(np.float32)
    p["transl"] = rng.normal(size=(B, 3)).astype(np.float32)
    ja = JB.forward(a, pose2rot=False,
                    **{k: jnp.asarray(v) for k, v in p.items()})
    ta = TB.forward(b, pose2rot=False,
                    **{k: torch.from_numpy(v) for k, v in p.items()})
    for k in OUTPUTS:
        np.testing.assert_allclose(getattr(ta, k).numpy(),
                                   np.asarray(getattr(ja, k)), atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("model_type", ["smpl", "smplh", "smplx", "mano",
                                        "flame"])
def test_init_body_params_shapes_match_jax(model_type):
    for pose_dim in (None, 33):
        a = JP.init_body_params(5, model_type, pose_dim=pose_dim)
        b = TP.init_body_params(5, model_type, pose_dim=pose_dim)
        assert {k: tuple(v.shape) for k, v in b.items()} == \
            {k: tuple(v.shape) for k, v in a.items()}
        assert all(float(v.abs().max()) == 0.0 for v in b.values())
    assert TP.PARAM_DIMS == JP.PARAM_DIMS


def test_forward_rejects_unknown_params_and_moves_hand_pca():
    _, b = _models("smplx", num_verts=64)
    p = {k: torch.from_numpy(v) for k, v in _params("smplx", B=1).items()}
    with pytest.raises(TypeError, match="wrist_pose"):
        TB.forward(b, wrist_pose=p["jaw_pose"], **p)
    # a hand-rig model moves its PCA arrays with the rest
    moved = b.to("cpu")
    assert moved.hand_mean_r is not None
    assert torch.equal(moved.hand_components_l, b.hand_components_l)
