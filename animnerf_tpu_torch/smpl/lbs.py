"""Linear blend skinning on tensors — counterpart of ``animnerf_tpu/smpl/lbs.py``.

Same math and the same pointer-doubling forward kinematics (log-depth
batched 4x4 products instead of a loop over the 24 joints), so results
match the JAX package to float32 rounding. The kinematic tree's index
arrays live on the host: each copy to the card waits for it, a
``wait.upload`` span (``utils/trace.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from animnerf_tpu_torch.utils import trace


def rodrigues(rot_vecs: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation matrices (with the
    reference's +1e-8 inside the norm)."""
    angle = torch.linalg.norm(rot_vecs + epsilon, dim=-1, keepdim=True)
    axis = rot_vecs / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([
        torch.stack([zeros, -rz, ry], dim=-1),
        torch.stack([rz, zeros, -rx], dim=-1),
        torch.stack([-ry, rx, zeros], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return eye + sin * K + (1.0 - cos) * (K @ K)


def blend_shapes(betas: torch.Tensor, shape_disps: torch.Tensor) -> torch.Tensor:
    """(B, L) x (V, 3, L) -> (B, V, 3)."""
    return torch.einsum("bl,mkl->bmk", betas, shape_disps)


def vertices2joints(J_regressor: torch.Tensor,
                    vertices: torch.Tensor) -> torch.Tensor:
    """(J, V) x (B, V, 3) -> (B, J, 3)."""
    return torch.einsum("bik,ji->bjk", vertices, J_regressor)


def transform_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4) homogeneous transforms."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def _doubling_steps(parents: np.ndarray) -> int:
    depth = 0
    for j in range(len(parents)):
        d, p = 0, j
        while p > 0:
            p = int(parents[p])
            d += 1
        depth = max(depth, d)
    steps = 0
    while (1 << steps) < max(depth, 1):
        steps += 1
    return steps + 1


def rigid_transform_chain(rot_mats: torch.Tensor, joints: torch.Tensor,
                          parents: np.ndarray):
    """Forward kinematics by pointer doubling. rot_mats (B, J, 3, 3),
    joints (B, J, 3) rest pose, parents (J,) host ints ->
    (posed_joints (B, J, 3), A (B, J, 4, 4) acting on rest-pose points)."""
    B, J = joints.shape[:2]
    parents = np.asarray(parents)
    rel_joints = joints.clone()
    with trace.wait("wait.upload"):  # parents[1:] copied to the card
        rel_joints[:, 1:] = joints[:, 1:] - joints[:, parents[1:]]
    local = transform_mat(rot_mats, rel_joints)
    eye = torch.eye(4, dtype=joints.dtype, device=joints.device)
    G = torch.cat([local, eye.expand(B, 1, 4, 4)], dim=1)  # identity at J
    p = parents.copy()
    p[0] = J
    p = np.concatenate([p, np.array([J])])
    for _ in range(_doubling_steps(parents)):
        with trace.wait("wait.upload"):
            p_t = torch.as_tensor(p, device=G.device)
        G = G[:, p_t] @ G
        p = p[p]
    world = G[:, :J]
    posed_joints = world[..., :3, 3]
    correction = torch.einsum("bjmn,bjn->bjm", world[..., :3, :3], joints)
    A = world.clone()
    A[..., :3, 3] = world[..., :3, 3] - correction
    return posed_joints, A


@dataclass
class LBSOutput:
    vertices: torch.Tensor            # (B, V, 3)
    joints: torch.Tensor              # (B, J, 3)
    joints_transform: torch.Tensor    # (B, J, 4, 4)  "A"
    vertices_transform: torch.Tensor  # (B, V, 4, 4)  "T"
    shape_offsets: torch.Tensor       # (B, V, 3)
    pose_offsets: torch.Tensor        # (B, V, 3)


def lbs(betas, pose, v_template, shapedirs, posedirs, J_regressor, parents,
        lbs_weights, pose2rot: bool = True) -> LBSOutput:
    """Full skinning from ``pose`` incl. global orient: axis-angle (B, J*3),
    or with ``pose2rot=False`` rotation matrices (B, J, 3, 3)."""
    B = max(betas.shape[0], pose.shape[0])
    shape_offsets = blend_shapes(betas, shapedirs)
    v_shaped = v_template[None] + shape_offsets
    joints_rest = vertices2joints(J_regressor, v_shaped)
    rot_mats = rodrigues(pose.reshape(B, -1, 3)) if pose2rot \
        else pose.reshape(B, -1, 3, 3)
    eye = torch.eye(3, dtype=v_template.dtype, device=v_template.device)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(B, -1)
    pose_offsets = (pose_feature @ posedirs).reshape(B, -1, 3)
    v_posed = v_shaped + pose_offsets
    posed_joints, A = rigid_transform_chain(rot_mats, joints_rest, parents)

    J = A.shape[1]
    T16 = torch.einsum("vj,bjc->bvc", lbs_weights.to(A.dtype),
                       A.reshape(B, J, 16))
    t = [T16[..., c] for c in range(12)]
    px, py, pz = v_posed[..., 0], v_posed[..., 1], v_posed[..., 2]
    verts = torch.stack(
        [t[0] * px + t[1] * py + t[2] * pz + t[3],
         t[4] * px + t[5] * py + t[6] * pz + t[7],
         t[8] * px + t[9] * py + t[10] * pz + t[11]], dim=-1)
    return LBSOutput(vertices=verts, joints=posed_joints, joints_transform=A,
                     vertices_transform=T16.reshape(B, -1, 4, 4),
                     shape_offsets=shape_offsets, pose_offsets=pose_offsets)
