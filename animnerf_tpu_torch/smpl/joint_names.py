"""Canonical joint-name tables for the SMPL body-model family (copy of
``animnerf_tpu/smpl/joint_names.py``).

The naming convention is the public SMPL-X/OpenPose standard (reference
smplx/joint_names.py — a flat 144-entry list). Here the tables are
generated from their structure: 24 SMPL body joints (+jaw/eyes for
SMPL-X), 15 per-hand articulated finger joints, face/foot/hand keypoints,
and the 51+17 face landmarks in OpenPose ordering. `joint_names(model)`
returns the prefix the respective model family actually produces.
"""

from __future__ import annotations

from functools import lru_cache

# 22 shared body joints (SMPL/SMPL-H/SMPL-X order)
_BODY = [
    "pelvis", "left_hip", "right_hip", "spine1", "left_knee", "right_knee",
    "spine2", "left_ankle", "right_ankle", "spine3", "left_foot",
    "right_foot", "neck", "left_collar", "right_collar", "head",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist",
]

_FINGERS = ["index", "middle", "pinky", "ring", "thumb"]


def _hand(side: str) -> list:
    return [f"{side}_{f}{i}" for f in _FINGERS for i in (1, 2, 3)]


def _keypoints() -> list:
    """Extra surface keypoints appended by VertexJointSelector: face,
    feet, then fingertips (smplx/vertex_joint_selector.py order)."""
    face = ["nose", "right_eye", "left_eye", "right_ear", "left_ear"]
    feet = [f"{s}_{p}" for s in ("left", "right")
            for p in ("big_toe", "small_toe", "heel")]
    tips = [f"{s}_{f}" for s in ("left", "right")
            for f in ("thumb", "index", "middle", "ring", "pinky")]
    return face + feet + tips


def _face_landmarks() -> list:
    """51 MPEG face landmarks + 17 contour points, OpenPose ordering."""
    names = []
    names += [f"right_eye_brow{i}" for i in (1, 2, 3, 4, 5)]
    names += [f"left_eye_brow{i}" for i in (5, 4, 3, 2, 1)]
    names += ["nose1", "nose2", "nose3", "nose4"]
    names += ["right_nose_2", "right_nose_1", "nose_middle",
              "left_nose_1", "left_nose_2"]
    names += [f"right_eye{i}" for i in (1, 2, 3, 4, 5, 6)]
    names += [f"left_eye{i}" for i in (4, 3, 2, 1, 6, 5)]
    names += ["right_mouth_1", "right_mouth_2", "right_mouth_3",
              "mouth_top", "left_mouth_3", "left_mouth_2", "left_mouth_1",
              "left_mouth_5", "left_mouth_4", "mouth_bottom",
              "right_mouth_4", "right_mouth_5"]
    names += ["right_lip_1", "right_lip_2", "lip_top", "left_lip_2",
              "left_lip_1", "left_lip_3", "lip_bottom", "right_lip_3"]
    names += [f"right_contour_{i}" for i in range(1, 9)]
    names += ["contour_middle"]
    names += [f"left_contour_{i}" for i in range(8, 0, -1)]
    return names


@lru_cache(maxsize=None)
def full_joint_names() -> tuple:
    """The complete 144-name SMPL-X output table (reference
    smplx/joint_names.py:17-163)."""
    return tuple(
        _BODY
        + ["jaw", "left_eye_smplhf", "right_eye_smplhf"]
        + _hand("left") + _hand("right")
        + _keypoints()
        + _face_landmarks()
    )


JOINT_NAMES = list(full_joint_names())


def joint_names(model_type: str = "smplx") -> list:
    """Names of the skeleton joints each family's LBS actually drives."""
    m = model_type.lower()
    if m == "smpl":
        # SMPL re-purposes the two wrist children as 'hands'
        return _BODY + ["left_hand", "right_hand"]
    if m == "smplh":
        return _BODY + _hand("left") + _hand("right")
    if m == "smplx":
        return (_BODY + ["jaw", "left_eye_smplhf", "right_eye_smplhf"]
                + _hand("left") + _hand("right"))
    if m == "mano":
        return ["wrist"] + _hand("right")
    if m == "flame":
        return ["global", "neck", "jaw", "left_eye", "right_eye"]
    raise ValueError(f"unknown model_type {model_type!r}")


def joint_index(name: str) -> int:
    """Index of `name` in the full SMPL-X output table."""
    return full_joint_names().index(name)
