"""Learnable per-frame body-model parameters — counterpart of
``animnerf_tpu/models/body_params.py`` (SMPL).

Layout: {'betas': (1, 10), 'global_orient': (F, 3), 'body_pose': (F, P),
'transl': (F, 3)}; betas are shared across frames.
"""

from __future__ import annotations

from typing import Optional

import torch

PARAM_DIMS = {
    "smpl": {"betas": 10, "global_orient": 3, "transl": 3, "body_pose": 69},
}


def init_body_params(num_frames: int, model_type: str = "smpl",
                     pose_dim: Optional[int] = None,
                     device=None) -> dict:
    """Zero-initialised store. pose_dim overrides the body_pose width (for
    reduced-joint synthetic rigs)."""
    if model_type not in PARAM_DIMS:
        raise NotImplementedError(
            f"model_type {model_type!r}: only SMPL is ported so far")
    dims = dict(PARAM_DIMS[model_type])
    if pose_dim is not None:
        dims["body_pose"] = pose_dim
    return {name: torch.zeros((1 if name == "betas" else num_frames, dim),
                              dtype=torch.float32, device=device)
            for name, dim in dims.items()}


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
