"""SMPL body model on tensors — counterpart of ``animnerf_tpu/smpl/body_model.py``.

``forward`` returns per-vertex transforms T, per-joint transforms A and the
shape/pose blendshape offsets besides vertices and joints, with ``transl``
folded into vertices, joints and the translation columns of A and T (the
Anim-NeRF modification of SMPL). Only ``model_type="smpl"`` is ported; the
other families raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from animnerf_tpu_torch.smpl import lbs as lbs_mod


@dataclass
class BodyModel:
    """SMPL model data: tensors on one device plus host-side topology."""

    v_template: torch.Tensor      # (V, 3)
    shapedirs: torch.Tensor       # (V, 3, num_betas)
    posedirs: torch.Tensor        # (9*(J-1), V*3)
    J_regressor: torch.Tensor     # (J, V)
    lbs_weights: torch.Tensor     # (V, J)
    parents: np.ndarray           # (J,) host ints
    faces: np.ndarray             # (F, 3)
    extra_joint_idxs: np.ndarray  # (E,)
    model_type: str = "smpl"
    gender: str = "neutral"

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]

    def to(self, device) -> "BodyModel":
        return replace(self, **{k: getattr(self, k).to(device) for k in (
            "v_template", "shapedirs", "posedirs", "J_regressor",
            "lbs_weights")})


@dataclass
class BodyModelOutput:
    vertices: torch.Tensor            # (B, V, 3)
    joints: torch.Tensor              # (B, J+E, 3)
    joints_transform: torch.Tensor    # (B, J, 4, 4)
    vertices_transform: torch.Tensor  # (B, V, 4, 4)
    shape_offsets: torch.Tensor       # (B, V, 3)
    pose_offsets: torch.Tensor        # (B, V, 3)


def forward(model: BodyModel, betas: torch.Tensor,
            global_orient: torch.Tensor,
            body_pose: Optional[torch.Tensor] = None,
            transl: Optional[torch.Tensor] = None, **extra) -> BodyModelOutput:
    """Pose the SMPL model from axis-angle parameters: betas (B, 10),
    global_orient (B, 3), body_pose (B, 69), transl (B, 3)."""
    if model.model_type != "smpl":
        raise NotImplementedError(
            f"model_type {model.model_type!r}: only SMPL is ported so far")
    unused = sorted(k for k, v in extra.items() if v is not None)
    if unused:
        raise NotImplementedError(f"SMPL forward takes no {unused}")
    full_pose = torch.cat([global_orient, body_pose], dim=1)
    out = lbs_mod.lbs(betas, full_pose, model.v_template, model.shapedirs,
                      model.posedirs, model.J_regressor, model.parents,
                      model.lbs_weights)
    extra_j = out.vertices[:, torch.as_tensor(model.extra_joint_idxs,
                                              device=out.vertices.device,
                                              dtype=torch.long)]
    joints = torch.cat([out.joints, extra_j], dim=1)
    vertices, A, T = out.vertices, out.joints_transform, out.vertices_transform
    if transl is not None:
        t = transl[:, None]
        vertices = vertices + t
        joints = joints + t
        A = A.clone()
        T = T.clone()
        A[..., :3, 3] = A[..., :3, 3] + t
        T[..., :3, 3] = T[..., :3, 3] + t
    return BodyModelOutput(vertices=vertices, joints=joints,
                           joints_transform=A, vertices_transform=T,
                           shape_offsets=out.shape_offsets,
                           pose_offsets=out.pose_offsets)
