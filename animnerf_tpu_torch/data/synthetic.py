"""Synthetic SMPL-topology rigs and datasets, as in the JAX package.

Copy of ``animnerf_tpu/data/synthetic.py``: ``make_rig`` and
``make_body_model`` (all five families) give arrays bit-identical to the
JAX package's for the same seed, so a checkpoint trained on a seeded rig
(for instance ``docs/demo/scale512``, seed 3) is served against exactly
its body model; ``write_synthetic_dataset`` writes a dataset in the
reference's on-disk layout through the port's body model and PNG writer.
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


def write_synthetic_dataset(root_dir: str, num_frames: int = 4,
                            img_wh: tuple = (64, 64), num_verts: int = 512,
                            num_joints: int = 24, seed: int = 0,
                            model_type: str = "smpl",
                            pose_scale: float = 0.15) -> str:
    """Write a dataset in the reference's layout: cam000/camera.pkl,
    cam000/images/*.png (RGBA, alpha the mask), {model_type}s/*.pkl,
    {model_type}_template.pkl (with fg/bg points and their signed
    distances) and the body model at models/SMPL_NEUTRAL.pkl. Frames are
    splat renders of the posed rig (a radius-2 disc per vertex, far ones
    first, coloured by the canonical position). The draws follow the JAX
    package's writer; returns the body-model file's path."""
    import os
    import pickle

    import torch

    from animnerf_tpu_torch.smpl.lbs import lbs
    from animnerf_tpu_torch.smpl.loader import save_model_data
    from animnerf_tpu_torch.utils.image import rasterize_disc, write_png

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root_dir, "cam000", "images")
    smpl_dir = os.path.join(root_dir, f"{model_type}s")
    model_dir = os.path.join(root_dir, "models")
    for d in (img_dir, smpl_dir, model_dir):
        os.makedirs(d, exist_ok=True)

    rig = make_rig(num_verts=num_verts, num_joints=num_joints, seed=seed)
    model_path = os.path.join(model_dir, "SMPL_NEUTRAL.pkl")
    save_model_data(model_path, rig)

    W, H = img_wh
    f = 1.2 * max(W, H)
    cam = {
        "R": np.eye(3),
        "t": np.array([0.0, -0.2, 2.5]),  # body ~2.5 m in front
        "camera_f": np.array([f, f], np.float64),
        "camera_c": np.array([W / 2.0, H / 2.0], np.float64),
        "camera_k": np.zeros(5),
        "height": H,
        "width": W,
    }
    with open(os.path.join(root_dir, "cam000", "camera.pkl"), "wb") as fh:
        pickle.dump(cam, fh)

    rig_t = {k: torch.from_numpy(np.asarray(rig[k])) for k in
             ("v_template", "shapedirs", "posedirs", "J_regressor",
              "lbs_weights")}

    def pose(params):
        full = np.concatenate([params["global_orient"],
                               params["body_pose"]], axis=1)
        with torch.no_grad():
            out = lbs(torch.from_numpy(params["betas"]),
                      torch.from_numpy(full), rig_t["v_template"],
                      rig_t["shapedirs"], rig_t["posedirs"],
                      rig_t["J_regressor"], rig["parents"],
                      rig_t["lbs_weights"])
        return out.vertices[0].numpy()

    betas = rng.normal(scale=0.3, size=(1, 10)).astype(np.float32)
    template = {
        "betas": betas,
        "global_orient": np.zeros((1, 3), np.float32),
        "body_pose": np.zeros((1, 3 * (num_joints - 1)), np.float32),
        "transl": np.zeros((1, 3), np.float32),
    }
    tmpl_verts = pose(template)

    # fg/bg points with signed distances: nearest-vertex distance minus a
    # 6 cm shell (inside < 0)
    pts = rng.uniform(-1.2, 1.2, size=(8192, 3)).astype(np.float32)
    center = tmpl_verts.mean(0)
    pts = pts + center
    d2 = ((pts[:, None] - tmpl_verts[None]) ** 2).sum(-1)
    distances = (np.sqrt(d2.min(1)) - 0.06).astype(np.float32)
    with open(os.path.join(root_dir, f"{model_type}_template.pkl"),
              "wb") as fh:
        pickle.dump(dict(template, points=pts, distances=distances), fh)

    K = np.array([[cam["camera_f"][0], 0, cam["camera_c"][0]],
                  [0, cam["camera_f"][1], cam["camera_c"][1]],
                  [0, 0, 1.0]])
    colours = (np.clip((tmpl_verts - center) * 2 + 0.5, 0, 1)
               * 255).astype(int)
    for i in range(num_frames):
        frame_id = i + 1
        params = {
            "betas": betas,
            "global_orient": rng.normal(scale=0.1, size=(1, 3)).astype(
                np.float32),
            "body_pose": rng.normal(
                scale=pose_scale,
                size=(1, 3 * (num_joints - 1))).astype(np.float32),
            "transl": np.array([[0.0, 0.0, 0.0]], np.float32)
            + rng.normal(scale=0.02, size=(1, 3)).astype(np.float32),
        }
        with open(os.path.join(smpl_dir, f"{frame_id:06d}.pkl"), "wb") as fh:
            pickle.dump(params, fh)

        verts = pose(params) + params["transl"][0]
        # the reference camera: x_cam = R @ x + t, image y down
        xc = verts @ np.asarray(cam["R"]).T + np.asarray(cam["t"])
        uv = (xc / xc[:, 2:3]) @ K.T
        order = np.argsort(-xc[:, 2])  # far first: nearer discs overwrite
        u = np.rint(uv[order, 0]).astype(np.int64)
        v = np.rint(uv[order, 1]).astype(np.int64)
        on = (u >= 0) & (u < W) & (v >= 0) & (v < H)
        img = np.zeros((H, W, 4), np.uint8)
        rgba = np.concatenate([colours[order[on]],
                               np.full((int(on.sum()), 1), 255)], axis=1)
        rasterize_disc(img, u[on], v[on], rgba)
        write_png(os.path.join(img_dir, f"{frame_id:06d}.png"),
                  img.reshape(H, W, 4))
    return model_path
