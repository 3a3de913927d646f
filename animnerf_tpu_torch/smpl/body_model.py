"""SMPL-family body models on tensors — counterpart of
``animnerf_tpu/smpl/body_model.py``.

``forward`` returns per-vertex transforms T, per-joint transforms A and the
shape/pose blendshape offsets besides vertices and joints, with ``transl``
folded into vertices, joints and the translation columns of A and T (the
Anim-NeRF modification of SMPL). Five families: SMPL, SMPL-H and SMPL-X
(hand poses through a PCA basis plus the mean hand pose; SMPL-X adds the
jaw and eye joints), MANO (hand rig) and FLAME (head rig: neck, jaw, eyes);
SMPL-X and FLAME add expression blendshapes when ``shapedirs`` holds
them after the shape directions. The extra joints' vertex indices are
copied to the card in a ``wait.upload`` span (``utils/trace.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from animnerf_tpu_torch.smpl import lbs as lbs_mod
from animnerf_tpu_torch.smpl.loader import load_model_data
from animnerf_tpu_torch.smpl.vertex_ids import extra_joint_ids
from animnerf_tpu_torch.utils import trace

# skeleton joints driven by LBS (incl. root) per family
NUM_JOINTS = {"smpl": 24, "smplh": 52, "smplx": 55, "mano": 16, "flame": 5}
NUM_BODY_JOINTS = {"smpl": 23, "smplh": 21, "smplx": 21}

_TENSORS = ("v_template", "shapedirs", "posedirs", "J_regressor",
            "lbs_weights", "hand_components_l", "hand_components_r",
            "hand_mean_l", "hand_mean_r")


@dataclass
class BodyModel:
    """Body-model data: tensors on one device plus host-side topology."""

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
    # SMPL-H/X (both sides) and MANO (left only) hand PCA; None for SMPL
    hand_components_l: Optional[torch.Tensor] = None  # (P, 45)
    hand_components_r: Optional[torch.Tensor] = None
    hand_mean_l: Optional[torch.Tensor] = None        # (45,)
    hand_mean_r: Optional[torch.Tensor] = None
    flat_hand_mean: bool = False

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]

    @property
    def num_betas(self) -> int:
        return self.shapedirs.shape[-1]

    def to(self, device) -> "BodyModel":
        return replace(self, **{k: getattr(self, k).to(device)
                                for k in _TENSORS
                                if getattr(self, k) is not None})


@dataclass
class BodyModelOutput:
    vertices: torch.Tensor            # (B, V, 3)
    joints: torch.Tensor              # (B, J+E, 3)
    joints_transform: torch.Tensor    # (B, J, 4, 4)
    vertices_transform: torch.Tensor  # (B, V, 4, 4)
    shape_offsets: torch.Tensor       # (B, V, 3)
    pose_offsets: torch.Tensor        # (B, V, 3)


def create(model_path: str, model_type: str = "smpl",
           gender: str = "neutral", num_betas: int = 10,
           num_pca_comps: int = 6,
           flat_hand_mean: bool = False) -> BodyModel:
    """A body model from a model file (the reference's layout, see
    ``loader.py::resolve_model_file``): the family's extra keypoint
    vertices after the skeleton joints and, for SMPL-H/X files that hold
    them, the first ``num_pca_comps`` hand PCA components. Keypoint ids
    beyond a small mesh's last vertex (a synthetic rig) take that vertex,
    as the JAX package's clamped gather does. On the CPU (move it with
    ``.to``)."""
    from animnerf_tpu_torch.utils.convert import body_model_from_arrays

    data = load_model_data(model_path, model_type, gender,
                           num_betas=num_betas)
    hands = {}
    if model_type in ("smplh", "smplx") and "hand_components_l" in data:
        hands = dict(
            hand_components_l=data["hand_components_l"][:num_pca_comps],
            hand_components_r=data["hand_components_r"][:num_pca_comps],
            hand_mean_l=data["hand_mean_l"], hand_mean_r=data["hand_mean_r"],
            flat_hand_mean=flat_hand_mean)
    V = data["v_template"].shape[0]
    return body_model_from_arrays(
        **{k: data[k] for k in ("v_template", "shapedirs", "posedirs",
                                "J_regressor", "lbs_weights", "parents",
                                "faces")},
        extra_joint_idxs=np.minimum(extra_joint_ids(model_type), V - 1),
        model_type=model_type, gender=gender, **hands)


def _hand_pose(model: BodyModel, pose_pca: torch.Tensor,
               side: str) -> torch.Tensor:
    comps = model.hand_components_l if side == "l" else model.hand_components_r
    mean = model.hand_mean_l if side == "l" else model.hand_mean_r
    full = pose_pca @ comps  # (B, 45)
    return full if model.flat_hand_mean else full + mean


def _shape_inputs(model: BodyModel, betas, expression):
    """SMPL-X/FLAME append the expression to the betas when shapedirs
    holds expression directions after the shape directions."""
    shapedirs = model.shapedirs
    if model.model_type in ("smplx", "flame") and expression is not None \
            and shapedirs.shape[-1] >= betas.shape[-1] + expression.shape[-1]:
        coeffs = torch.cat([betas, expression], dim=-1)
        return coeffs, shapedirs[..., :coeffs.shape[-1]]
    return betas, shapedirs


def forward(model: BodyModel, betas: torch.Tensor,
            global_orient: torch.Tensor,
            body_pose: Optional[torch.Tensor] = None,
            transl: Optional[torch.Tensor] = None,
            left_hand_pose: Optional[torch.Tensor] = None,
            right_hand_pose: Optional[torch.Tensor] = None,
            hand_pose: Optional[torch.Tensor] = None,
            jaw_pose: Optional[torch.Tensor] = None,
            neck_pose: Optional[torch.Tensor] = None,
            leye_pose: Optional[torch.Tensor] = None,
            reye_pose: Optional[torch.Tensor] = None,
            expression: Optional[torch.Tensor] = None,
            pose2rot: bool = True, **extra) -> BodyModelOutput:
    """Pose the body model: betas (B, num_betas), global_orient (B, 3),
    body_pose (B, 69) SMPL / (B, 63) SMPL-H/X, transl (B, 3), hand poses
    as PCA coefficients (B, P) (``hand_pose`` for MANO), jaw / neck / eye
    poses (B, 3), expression (B, 10). Arguments another family uses are
    ignored, as in the JAX package; unknown ones raise.

    ``pose2rot=False`` (the reference's ``*Layer`` semantics): every pose
    argument is rotation matrices, (B, n, 3, 3) or (B, n*9), and hand poses
    are full 15-joint rotations (no PCA decode)."""
    unknown = sorted(k for k, v in extra.items() if v is not None)
    if unknown:
        raise TypeError(f"forward takes no {unknown}")
    mt = model.model_type
    if mt not in NUM_JOINTS:
        raise ValueError(f"unknown model_type {mt!r}")
    B = betas.shape[0]
    if pose2rot:
        zeros3 = betas.new_zeros(B, 3)

        def part(x, n):
            return zeros3 if x is None else x
    else:
        eye = torch.eye(3, dtype=betas.dtype, device=betas.device)

        def part(x, n):
            if x is None:
                return eye.expand(B, n, 3, 3)
            return x.reshape(B, n, 3, 3)

    def hand(x, side):
        """15 finger joints: PCA-decoded axis-angle, or given matrices."""
        return _hand_pose(model, x, side) if pose2rot else part(x, 15)

    if mt == "smpl":
        parts = [part(global_orient, 1),
                 body_pose if pose2rot else part(body_pose,
                                                 model.num_joints - 1)]
    elif mt == "mano":
        hp = hand_pose if hand_pose is not None else left_hand_pose
        no_pca = pose2rot and model.hand_components_l is None
        parts = [part(global_orient, 1), hp if no_pca else hand(hp, "l")]
    elif mt == "flame":
        parts = [part(p, 1) for p in (global_orient, neck_pose, jaw_pose,
                                      leye_pose, reye_pose)]
    else:
        body = body_pose if pose2rot else part(body_pose, 21)
        parts = [part(global_orient, 1), body]
        if mt == "smplx":
            parts += [part(p, 1) for p in (jaw_pose, leye_pose, reye_pose)]
        parts += [hand(left_hand_pose, "l"), hand(right_hand_pose, "r")]
    full_pose = torch.cat(parts, dim=1)

    coeffs, shapedirs = _shape_inputs(model, betas, expression)
    out = lbs_mod.lbs(coeffs, full_pose, model.v_template, shapedirs,
                      model.posedirs, model.J_regressor, model.parents,
                      model.lbs_weights, pose2rot=pose2rot)
    with trace.wait("wait.upload"):
        extra_idx = torch.as_tensor(model.extra_joint_idxs,
                                    device=out.vertices.device,
                                    dtype=torch.long)
    extra_j = out.vertices[:, extra_idx]
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
