"""Shared CLI plumbing — counterpart of ``animnerf_tpu/cli/common.py``:
the config from a checkpoint, a frame's body parameters, a camera and its
rays, the trained system.

``resolve_cfg`` takes the checkpoint's ``meta.json["cfg"]``, then the YAML
file, then the options; a checkpoint directory without ``meta.json`` (a
bare parameter directory) relies on ``--cfg_file``. The loaders return
tensors on the device they are given (the card unless ``"cpu"``); the
camera's intrinsics are scaled and its rays generated in numpy first, as
the JAX package does, so the rays are bit-equal to its rays.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from animnerf_tpu_torch.config import CfgNode, finalize, get_default_config
from animnerf_tpu_torch.smpl.loader import load_pickle
from animnerf_tpu_torch.utils.device import DeviceLike, resolve_device


def resolve_cfg(ckpt_path: Optional[str], cfg_file: Optional[str] = None,
                opts: Optional[list] = None) -> CfgNode:
    """Config priority: checkpoint-stored cfg -> YAML file -> CLI opts."""
    from animnerf_tpu_torch.training.checkpoints import load_metadata

    cfg = get_default_config()
    if ckpt_path:
        if not os.path.exists(ckpt_path):
            raise FileNotFoundError(f"checkpoint not found: {ckpt_path!r}")
        try:
            cfg.merge_from_dict(load_metadata(ckpt_path).get("cfg", {}))
        except FileNotFoundError:
            pass  # bare param dir without meta.json: rely on --cfg_file
    if cfg_file:
        cfg.merge_from_file(cfg_file)
    if opts:
        cfg.merge_from_list(opts)
    return finalize(cfg)


def _param_rows(cfg: CfgNode, raw: dict, device) -> dict:
    """The family's keys of a params pkl as (1, dim) float32 tensors,
    body_pose cut to the config's pose_dim."""
    from animnerf_tpu_torch.data.dataset import PARAM_KEYS

    pose_dim = cfg.get("pose_dim") or (69 if cfg.model_type == "smpl" else 63)
    out = {}
    for k in PARAM_KEYS[cfg.model_type]:
        if k in raw:
            v = np.asarray(raw[k], np.float32).reshape(-1)
            if k == "body_pose":
                v = v[:pose_dim]
            out[k] = torch.from_numpy(v.copy())[None].to(device)
    return out


def load_frame_params(cfg: CfgNode, frame_id: int,
                      device: DeviceLike = None):
    """(frame_idx, body params, template body params), each param (1, dim);
    frame_idx is the frame's index among the trained frames, else -1."""
    dev = resolve_device(device)
    params = _param_rows(cfg, load_pickle(os.path.join(
        cfg.root_dir, f"{cfg.model_type}s", f"{frame_id:06d}.pkl")), dev)
    template = _param_rows(cfg, load_pickle(os.path.join(
        cfg.root_dir, f"{cfg.model_type}_template.pkl")), dev)
    frame_ids_index = {fid: i for i, fid in enumerate(cfg.frame_IDs)}
    return frame_ids_index.get(frame_id, -1), params, template


def load_cam_and_rays(cfg: CfgNode, cam_id: int, near: float = 0.1,
                      far: float = 10.0, device: DeviceLike = None):
    """(cam dict scaled to img_wh, dense (H*W, 8) rays on the device)."""
    from animnerf_tpu_torch.ops.ray_utils import camera_to_c2w, gen_rays

    dev = resolve_device(device)
    cam = load_pickle(os.path.join(cfg.root_dir, f"cam{cam_id:03d}",
                                   "camera.pkl"))
    W, H = cfg.img_wh
    cam = dict(cam)
    sx, sy = W / cam["width"], H / cam["height"]
    cam["camera_f"] = np.asarray(cam["camera_f"], np.float64) * [sx, sy]
    cam["camera_c"] = np.asarray(cam["camera_c"], np.float64) * [sx, sy]
    cam["height"], cam["width"] = H, W
    c2w = camera_to_c2w(np.asarray(cam["R"], np.float64),
                        np.asarray(cam["t"], np.float64))
    rays = gen_rays(c2w.astype(np.float32), H, W, cam["camera_f"],
                    near, far, cam["camera_c"]).reshape(-1, 8)
    return cam, torch.from_numpy(rays).to(dev)


def load_system_and_params(cfg: CfgNode, ckpt_path: str,
                           device: DeviceLike = None):
    """The system of the config on the device, with the checkpoint's field
    and trained per-frame body parameters (as ``training/loop.py::
    evaluate`` loads them)."""
    from animnerf_tpu_torch.models.body_params import (
        load_body_params_from_dataset,
    )
    from animnerf_tpu_torch.training.checkpoints import load_params
    from animnerf_tpu_torch.training.loop import build_system

    system = build_system(cfg, resolve_device(device))
    system.set_body_params(load_body_params_from_dataset(
        cfg.frame_IDs, cfg.root_dir, cfg.model_type))
    load_params(ckpt_path, system)
    return system


def optimized_frame_params(cfg: CfgNode, system, frame_idx: int,
                           fallback: dict) -> dict:
    """The trained per-frame params of frame_idx, or the given pkl params
    when the frame wasn't trained (frame_idx == -1)."""
    from animnerf_tpu_torch.models.body_params import lookup_body_params

    if frame_idx < 0 or not cfg.optim_body_params:
        return fallback
    with torch.no_grad():
        return {k: v.detach().clone() for k, v in lookup_body_params(
            dict(system.body_params), torch.tensor(
                [frame_idx], device=system.device)).items()}
