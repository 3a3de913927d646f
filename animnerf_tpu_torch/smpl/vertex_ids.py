"""Keypoint-vertex index tables for SMPL-family meshes.

Copy of ``animnerf_tpu/smpl/vertex_ids.py``: public topology constants
(which mesh vertex corresponds to which OpenPose/MSCOCO landmark) shared
by every SMPL implementation.

Stored here as flat ordered arrays in the exact order the extra-joint
selector appends them: 5 face, 6 feet, 10 finger tips (left hand then
right, thumb/index/middle/ring/pinky).
"""

import numpy as np

# fmt: off
# order: nose, reye, leye, rear, lear,
#        LBigToe, LSmallToe, LHeel, RBigToe, RSmallToe, RHeel,
#        lthumb, lindex, lmiddle, lring, lpinky,
#        rthumb, rindex, rmiddle, rring, rpinky
EXTRA_JOINT_VERTEX_IDS = {
    # SMPL and SMPL-H share topology (6890 verts)
    "smpl":  np.array([332, 6260, 2800, 4071, 583,
                       3216, 3226, 3387, 6617, 6624, 6787,
                       2746, 2319, 2445, 2556, 2673,
                       6191, 5782, 5905, 6016, 6133], dtype=np.int32),
    "smplx": np.array([9120, 9929, 9448, 616, 6,
                       5770, 5780, 8846, 8463, 8474, 8635,
                       5361, 4933, 5058, 5169, 5286,
                       8079, 7669, 7794, 7905, 8022], dtype=np.int32),
}
EXTRA_JOINT_VERTEX_IDS["smplh"] = EXTRA_JOINT_VERTEX_IDS["smpl"]

MANO_TIP_VERTEX_IDS = np.array([744, 320, 443, 554, 671], dtype=np.int32)
# fmt: on


def extra_joint_ids(model_type: str, use_hands: bool = True,
                    use_feet_keypoints: bool = True) -> np.ndarray:
    """Vertex ids of the extra joints appended after the skeleton joints."""
    ids = EXTRA_JOINT_VERTEX_IDS[model_type]
    face = ids[:5]
    feet = ids[5:11]
    hands = ids[11:]
    parts = [face]
    if use_feet_keypoints:
        parts.append(feet)
    if use_hands:
        parts.append(hands)
    return np.concatenate(parts)
