"""Learnable per-frame body-model parameters — counterpart of
``animnerf_tpu/models/body_params.py``.

Layout: {'betas': (1, 10), 'global_orient': (F, 3), 'body_pose': (F, P),
'transl': (F, 3), ...} with the family's further keys (hand PCA, jaw,
neck, eyes, expression); betas are shared across frames.
"""

from __future__ import annotations

from typing import Optional

import torch

PARAM_DIMS = {
    "smpl": {"betas": 10, "global_orient": 3, "transl": 3, "body_pose": 69},
    "smplh": {"betas": 10, "global_orient": 3, "transl": 3, "body_pose": 63,
              "left_hand_pose": 6, "right_hand_pose": 6},
    "smplx": {"betas": 10, "global_orient": 3, "transl": 3, "body_pose": 63,
              "left_hand_pose": 6, "right_hand_pose": 6, "jaw_pose": 3,
              "expression": 10},
    "mano": {"betas": 10, "global_orient": 3, "transl": 3, "hand_pose": 6},
    "flame": {"betas": 10, "global_orient": 3, "transl": 3, "neck_pose": 3,
              "jaw_pose": 3, "leye_pose": 3, "reye_pose": 3,
              "expression": 10},
}


def init_body_params(num_frames: int, model_type: str = "smpl",
                     pose_dim: Optional[int] = None,
                     device=None) -> dict:
    """Zero-initialised store. pose_dim overrides the body_pose width (for
    reduced-joint synthetic rigs; the reference's cfg.pose_dim)."""
    if model_type not in PARAM_DIMS:
        raise ValueError(f"unknown model_type {model_type!r}")
    dims = dict(PARAM_DIMS[model_type])
    if pose_dim is not None:
        dims["body_pose"] = pose_dim
    return {name: torch.zeros((1 if name == "betas" else num_frames, dim),
                              dtype=torch.float32, device=device)
            for name, dim in dims.items()}


def load_body_params_from_dataset(frame_ids: list, root_dir: str,
                                  model_type: str = "smpl") -> dict:
    """The per-frame params of a dataset's ``{model_type}s/{id:06d}.pkl``
    files as float32 tensors (F, dim), a key a file lacks as zeros, each
    cut to the family's width; betas (1, 10) are the mean over frames."""
    import os

    import numpy as np

    from animnerf_tpu_torch.smpl.loader import load_pickle

    dims = PARAM_DIMS[model_type]
    per_frame: dict = {k: [] for k in dims}
    for fid in frame_ids:
        raw = load_pickle(os.path.join(root_dir, f"{model_type}s",
                                       f"{fid:06d}.pkl"))
        for k in dims:
            if k in raw:
                per_frame[k].append(
                    np.asarray(raw[k], np.float32).reshape(-1))
            else:
                per_frame[k].append(np.zeros(dims[k], np.float32))
    out = {}
    for k, dim in dims.items():
        arr = np.stack(per_frame[k])[:, :dim]
        if k == "betas":
            arr = arr.mean(axis=0, keepdims=True)
        out[k] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def lookup_body_params(body_params: dict,
                       frame_idx: torch.Tensor) -> dict:
    """The per-frame params of a batch of frame indices; betas are
    frame-shared (row 0)."""
    out = {}
    for k, v in body_params.items():
        if k == "betas":
            out[k] = v[0].expand(frame_idx.shape[0], v.shape[-1])
        else:
            out[k] = v[frame_idx.long()]
    return out


def batch_params_from_data(batch: dict, model_type: str = "smpl",
                           template: bool = False) -> dict:
    """The (template) body params carried in a data batch."""
    suffix = "_template" if template else ""
    return {k: batch[k + suffix] for k in PARAM_DIMS[model_type]
            if k + suffix in batch}
