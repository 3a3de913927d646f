"""Synthetic SMPL-topology rigs (numpy only), as in the JAX package.

Copy of ``animnerf_tpu/data/synthetic.py::make_rig`` and
``make_body_model`` (all five families): for the same seed the arrays are
bit-identical to the JAX package's, so a checkpoint trained on a seeded
rig (for instance ``docs/demo/scale512``, seed 3) is served against
exactly its body model.
"""

from __future__ import annotations

import numpy as np


def make_rig(num_verts: int = 256, num_joints: int = 24, num_betas: int = 10,
             seed: int = 0, surface: bool = False) -> dict:
    """Synthetic body-model dict (keys of the SMPL loader's output):
    a branching chain of joints, vertices scattered around the bones (or on
    capsule surfaces with ``surface=True``), smooth top-4 LBS weights,
    small random blendshape bases. All float arrays are float32."""
    rng = np.random.default_rng(seed)
    J, V = num_joints, num_verts

    parents = np.empty(J, dtype=np.int32)
    parents[0] = -1
    for j in range(1, J):
        parents[j] = j - 1 if rng.random() < 0.7 else rng.integers(0, j)

    joints_rest = np.zeros((J, 3), dtype=np.float32)
    for j in range(1, J):
        offset = rng.normal(scale=0.12, size=3).astype(np.float32)
        offset[1] += 0.08  # grow upward
        joints_rest[j] = joints_rest[parents[j]] + offset

    if surface:
        n_phi = 8
        per_bone = max(n_phi, V // (J - 1) // n_phi * n_phi)
        pts = []
        for j in range(1, J):
            a = joints_rest[j] - joints_rest[parents[j]]
            ln = np.linalg.norm(a) + 1e-8
            a_hat = a / ln
            ref = np.array([0.0, 0.0, 1.0], np.float32)
            if abs(a_hat @ ref) > 0.9:
                ref = np.array([1.0, 0.0, 0.0], np.float32)
            n1 = np.cross(a_hat, ref)
            n1 /= np.linalg.norm(n1) + 1e-8
            n2 = np.cross(a_hat, n1)
            r = 0.03 + 0.03 * rng.random()
            n_t = per_bone // n_phi
            t = np.linspace(0.0, 1.0, n_t, dtype=np.float32)[:, None, None]
            phi = (np.linspace(0.0, 2 * np.pi, n_phi, endpoint=False,
                               dtype=np.float32)[None, :, None]
                   + rng.random() * 2 * np.pi)
            ring = r * (np.cos(phi) * n1[None, None] +
                        np.sin(phi) * n2[None, None])
            pts.append((joints_rest[parents[j]][None, None]
                        + t * a[None, None] + ring).reshape(-1, 3))
        v_template = np.concatenate(pts, axis=0)
        if len(v_template) < V:
            extra = rng.integers(0, len(v_template), size=V - len(v_template))
            v_template = np.concatenate(
                [v_template, v_template[extra]
                 + rng.normal(scale=0.005, size=(len(extra), 3))], axis=0)
        v_template = v_template[:V].astype(np.float32)
    else:
        bone_choice = rng.integers(1, J, size=V)
        t = rng.random(V).astype(np.float32)[:, None]
        v_template = (
            joints_rest[parents[bone_choice]] * (1 - t)
            + joints_rest[bone_choice] * t
            + rng.normal(scale=0.04, size=(V, 3)).astype(np.float32)
        )

    d2 = ((v_template[:, None] - joints_rest[None]) ** 2).sum(-1) + 1e-4
    w = 1.0 / d2
    top4 = np.argsort(-w, axis=1)[:, :4]
    mask = np.zeros_like(w)
    np.put_along_axis(mask, top4, 1.0, axis=1)
    w = w * mask
    lbs_weights = (w / w.sum(1, keepdims=True)).astype(np.float32)

    jr = 1.0 / d2.T  # (J, V)
    topv = np.argsort(-jr, axis=1)[:, :8]
    m = np.zeros_like(jr)
    np.put_along_axis(m, topv, 1.0, axis=1)
    jr = jr * m
    J_regressor = (jr / jr.sum(1, keepdims=True)).astype(np.float32)

    shapedirs = rng.normal(scale=0.01, size=(V, 3, num_betas)).astype(np.float32)
    posedirs = rng.normal(scale=0.001,
                          size=(9 * (J - 1), V * 3)).astype(np.float32)

    idx = np.arange(V, dtype=np.int32)
    faces = np.stack([idx, (idx + 1) % V, (idx + 2) % V], axis=1)

    return {
        "v_template": v_template,
        "shapedirs": shapedirs,
        "posedirs": posedirs,
        "J_regressor": J_regressor,
        "parents": parents,
        "lbs_weights": lbs_weights,
        "faces": faces,
    }


def make_body_model(num_verts: int = 256, num_joints: int = 24,
                    num_betas: int = 10, seed: int = 0,
                    model_type: str = "smpl", num_pca: int = 6,
                    surface: bool = False):
    """Synthetic ``BodyModel`` on the CPU (move it with ``.to``). SMPL-H,
    SMPL-X, MANO and FLAME rigs get their family's joint count (52 / 55 /
    16 / 5) unless ``num_joints`` is set to another value than 24, and the
    hand families random hand-PCA bases (num_pca, 45) and mean poses (45,)
    from ``default_rng(seed + 77)``, drawn in the JAX package's order."""
    from animnerf_tpu_torch.smpl.body_model import NUM_JOINTS
    from animnerf_tpu_torch.utils.convert import body_model_from_arrays

    if model_type not in NUM_JOINTS:
        raise ValueError(f"unknown model_type {model_type!r}")
    if model_type != "smpl" and num_joints == 24:
        num_joints = NUM_JOINTS[model_type]
    rig = make_rig(num_verts, num_joints, num_betas, seed, surface=surface)
    rig["extra_joint_idxs"] = np.arange(min(4, num_verts), dtype=np.int32)
    if model_type in ("smplh", "smplx", "mano"):
        rng = np.random.default_rng(seed + 77)

        def draw(scale, size):
            return rng.normal(scale=scale, size=size).astype(np.float32)

        if model_type == "mano":
            rig["hand_components_l"] = draw(0.1, (num_pca, 45))
            rig["hand_mean_l"] = draw(0.02, 45)
        else:
            rig["hand_components_l"] = draw(0.1, (num_pca, 45))
            rig["hand_components_r"] = draw(0.1, (num_pca, 45))
            rig["hand_mean_l"] = draw(0.02, 45)
            rig["hand_mean_r"] = draw(0.02, 45)
    return body_model_from_arrays(**rig, model_type=model_type)


def random_pose_params(num_joints: int = 24, num_betas: int = 10,
                       batch: int = 1, seed: int = 0,
                       scale: float = 0.3) -> dict:
    """Random SMPL parameters (numpy float32), the same draws as the JAX
    package's ``random_pose_params`` for the same seed."""
    rng = np.random.default_rng(seed)
    return {
        "betas": rng.normal(scale=0.5, size=(batch, num_betas)).astype(np.float32),
        "global_orient": rng.normal(scale=scale, size=(batch, 3)).astype(np.float32),
        "body_pose": rng.normal(
            scale=scale, size=(batch, 3 * (num_joints - 1))
        ).astype(np.float32),
        "transl": rng.normal(scale=0.5, size=(batch, 3)).astype(np.float32),
    }
