"""What the traffic kinds' generators share (``kinds/<kind>.py`` reads
its mixes, the JSON files under ``benchmark/traffic/``): the body
parameters of each model type and the seeded draw of poses. All sizes
and draws come from a mix's file; nothing here names a cell.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PARAM_DIMS = {
    "smpl": {"betas": 10, "global_orient": 3, "body_pose": 69, "transl": 3},
    "smplx": {"betas": 10, "global_orient": 3, "body_pose": 63, "transl": 3,
              "left_hand_pose": 6, "right_hand_pose": 6, "jaw_pose": 3,
              "expression": 10},
}


def num_frames(config: dict) -> int:
    t = config["train"]
    return len(range(t["frame_start_ID"], t["frame_end_ID"] + 1,
                     t["frame_skip"]))


def draw_poses(model_type: str, n: int, rng: np.random.Generator,
               pose_scale: float, turn: bool) -> tuple:
    """(observed params {key: (n, dim)} (betas (1, 10)), template params
    {key: (1, dim)}: the same betas, every other key zero), float32."""
    obs = {}
    for k, dim in PARAM_DIMS[model_type].items():
        rows = 1 if k == "betas" else n
        scale = 0.5 if k in ("betas", "expression") else \
            0.05 if k == "transl" else pose_scale
        obs[k] = rng.normal(scale=scale, size=(rows, dim)).astype(np.float32)
    if turn:  # the subject turns in place in front of the camera
        obs["global_orient"][:, 1] += rng.uniform(
            0, 2 * math.pi, size=n).astype(np.float32)
    tmpl = {k: np.zeros((1, dim), np.float32) for k, dim in
            PARAM_DIMS[model_type].items()}
    tmpl["betas"] = obs["betas"].copy()
    return obs, tmpl


def to_tensors(d: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in d.items()}
