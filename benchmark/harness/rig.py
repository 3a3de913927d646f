"""Seeded synthetic body rigs (frozen copy of the repository's rig
generator, ``data/synthetic.py::make_rig`` / ``make_body_model`` as of
this benchmark): SMPL's licensed model file cannot be shipped, so a
configuration names a rig by its sizes and seed. Both the program and
the reference are handed these arrays.

A branching chain of joints, vertices scattered around the bones, smooth
top-4 LBS weights, small random blend-shape bases; SMPL-X rigs add
hand-PCA bases and mean poses drawn from ``default_rng(seed + 77)``.
"""

from __future__ import annotations

import numpy as np

FAMILY_JOINTS = {"smpl": 24, "smplx": 55}


def make_rig(num_verts: int, num_joints: int, num_betas: int = 10,
             seed: int = 0, model_type: str = "smpl",
             num_pca: int = 6) -> dict:
    rng = np.random.default_rng(seed)
    J, V = num_joints, num_verts
    parents = np.empty(J, dtype=np.int32)
    parents[0] = -1
    for j in range(1, J):
        parents[j] = j - 1 if rng.random() < 0.7 else rng.integers(0, j)
    joints_rest = np.zeros((J, 3), dtype=np.float32)
    for j in range(1, J):
        offset = rng.normal(scale=0.12, size=3).astype(np.float32)
        offset[1] += 0.08
        joints_rest[j] = joints_rest[parents[j]] + offset
    bone_choice = rng.integers(1, J, size=V)
    t = rng.random(V).astype(np.float32)[:, None]
    v_template = (joints_rest[parents[bone_choice]] * (1 - t)
                  + joints_rest[bone_choice] * t
                  + rng.normal(scale=0.04, size=(V, 3)).astype(np.float32))
    d2 = ((v_template[:, None] - joints_rest[None]) ** 2).sum(-1) + 1e-4
    w = 1.0 / d2
    top4 = np.argsort(-w, axis=1)[:, :4]
    mask = np.zeros_like(w)
    np.put_along_axis(mask, top4, 1.0, axis=1)
    w = w * mask
    lbs_weights = (w / w.sum(1, keepdims=True)).astype(np.float32)
    jr = 1.0 / d2.T
    topv = np.argsort(-jr, axis=1)[:, :8]
    m = np.zeros_like(jr)
    np.put_along_axis(m, topv, 1.0, axis=1)
    jr = jr * m
    J_regressor = (jr / jr.sum(1, keepdims=True)).astype(np.float32)
    shapedirs = rng.normal(scale=0.01, size=(V, 3, num_betas)).astype(
        np.float32)
    posedirs = rng.normal(scale=0.001, size=(9 * (J - 1), V * 3)).astype(
        np.float32)
    idx = np.arange(V, dtype=np.int32)
    rig = {"v_template": v_template, "shapedirs": shapedirs,
           "posedirs": posedirs, "J_regressor": J_regressor,
           "parents": parents, "lbs_weights": lbs_weights,
           "faces": np.stack([idx, (idx + 1) % V, (idx + 2) % V], axis=1),
           "extra_joint_idxs": np.arange(min(4, V), dtype=np.int32)}
    if model_type == "smplx":
        hr = np.random.default_rng(seed + 77)

        def draw(scale, size):
            return hr.normal(scale=scale, size=size).astype(np.float32)

        rig["hand_components_l"] = draw(0.1, (num_pca, 45))
        rig["hand_components_r"] = draw(0.1, (num_pca, 45))
        rig["hand_mean_l"] = draw(0.02, 45)
        rig["hand_mean_r"] = draw(0.02, 45)
    return rig


def config_rig(config: dict) -> dict:
    return make_rig(config["num_verts"], config["num_joints"],
                    config["num_betas"], config["rig_seed"],
                    config["model_type"])
