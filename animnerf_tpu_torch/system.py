"""AnimNeRF system — counterpart of
``animnerf_tpu/training/system.py::AnimNeRFSystem``.

Builds ``scene_cfg`` (``AnimNeRFConfig``), ``renderer_cfg``
(``RendererConfig``), the training options (``train_cfg``, the reference's
``train`` section) and the scene model from a config dict with the
reference's keys (a checkpoint's ``meta.json["cfg"]`` is one), and holds
the body model and the learnable per-frame body parameters. Parameters
live in the ``nn.Module`` tree; load them with ``load_anim_nerf`` or
``load_params`` (see ``utils/convert.py``). The training step's functions
take the system: ``training/system.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from animnerf_tpu_torch.models.anim_nerf import AnimNeRFConfig, AnimNeRFModel
from animnerf_tpu_torch.models.body_params import init_body_params
from animnerf_tpu_torch.render.volume_renderer import RendererConfig
from animnerf_tpu_torch.smpl.body_model import BodyModel
from animnerf_tpu_torch.utils.device import DeviceLike, resolve_device


# config values the port does not cover yet, and the value it supports
UNPORTED = {"use_view": False, "use_deformation": False,
            "deformation_dim": 0, "apperance_dim": 0, "use_unpose": True,
            "unpose_view": False, "n_depth": 0}
# k_neigh: the kNN kernels are instantiated for 1..16 neighbours
MAX_K_NEIGH = 16


# the reference's train section (config.py there) as the step reads it
TRAIN_DEFAULTS = {
    "lambda_alphas": 0.1, "lambda_foreground": 0.01,
    "lambda_background": 0.01, "lambda_normals": 0.01, "epsilon": 0.01,
    "batch_size": 16, "max_epochs": 30, "lr": 5e-4,
    "optimizer": {"type": "adam", "momentum": 0.9, "weight_decay": 0},
    "scheduler": {"type": "poly", "poly_exp": 0.9},
}


def train_config(cfg: dict) -> dict:
    """cfg["train"] over TRAIN_DEFAULTS (nested sections merged)."""
    given = dict(cfg.get("train") or {})
    out = dict(TRAIN_DEFAULTS, **given)
    for sec in ("optimizer", "scheduler"):
        out[sec] = dict(TRAIN_DEFAULTS[sec], **dict(given.get(sec) or {}))
    return out


def num_frames(cfg: dict) -> int:
    """cfg["num_frames"] when given, else the length of the training frame
    range (the JAX package's ``finalize``): range(frame_start_ID,
    frame_end_ID + 1, frame_skip) of cfg["train"], defaults 1, 400, 4."""
    if cfg.get("num_frames") is not None:
        return int(cfg["num_frames"])
    t = cfg.get("train") or {}
    return len(range(int(t.get("frame_start_ID", 1)),
                     int(t.get("frame_end_ID", 400)) + 1,
                     int(t.get("frame_skip", 4))))


def resolve_compute_dtype(value: str, device) -> str:
    """'auto' is bfloat16 on the card (the fused MLP's fast path) and
    float32 on the CPU, as the JAX package resolves it per backend."""
    if value == "auto":
        return "bfloat16" if device.type == "cuda" else "float32"
    if value not in ("bfloat16", "float32"):
        raise ValueError(f"compute_dtype {value!r}")
    return value


class AnimNeRFSystem(nn.Module):
    """Config + scene model + body model, on one device."""

    def __init__(self, cfg: dict, body_model: BodyModel,
                 device: DeviceLike = None, seed: Optional[int] = None):
        """seed: draws the field's initial weights from a torch.Generator
        (flax's initialisers, not flax's numbers); None draws them from the
        global generator."""
        super().__init__()
        dev = resolve_device(device)
        g = cfg.get
        bad = [f"{k}={g(k)!r}" for k, want in UNPORTED.items()
               if k in cfg and g(k) != want]
        if bad:
            raise NotImplementedError(
                "not ported yet (the port covers the flagship field): "
                f"{', '.join(bad)}")
        k_neigh = int(g("k_neigh", 4))
        if not 1 <= k_neigh <= MAX_K_NEIGH:
            raise NotImplementedError(
                f"k_neigh={k_neigh}: the port's kNN kernels take 1 to "
                f"{MAX_K_NEIGH} neighbours")
        n_fine = int(g("n_importance", 16))
        self.scene_cfg = AnimNeRFConfig(
            freqs_xyz=int(g("freqs_xyz", 10)),
            use_fine=n_fine > 0,
            share_fine=bool(g("share_fine", False)),
            dis_threshold=float(g("dis_threshold", 0.2)),
            k_neigh=k_neigh,
            query_inside=bool(g("query_inside", False)),
            compute_dtype=resolve_compute_dtype(
                str(g("compute_dtype", "auto")), dev),
        )
        self.renderer_cfg = RendererConfig(
            n_coarse=int(g("n_samples", 64)), n_fine=n_fine,
            white_bkgd=bool(g("white_bkgd", True)))
        self.cfg = dict(cfg)
        self.train_cfg = train_config(cfg)
        self.model_type = str(g("model_type", "smpl"))
        self.optim_body_params = bool(g("optim_body_params", True))
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        self.scene = AnimNeRFModel(self.scene_cfg, generator=gen)
        self.body_model = body_model
        self.body_params = nn.ParameterDict({
            k: nn.Parameter(v) for k, v in init_body_params(
                num_frames(cfg), self.model_type,
                pose_dim=g("pose_dim")).items()})
        self.to_device(dev)

    def to_device(self, device) -> "AnimNeRFSystem":
        self.device = resolve_device(device)
        self.to(self.device)
        self.body_model = self.body_model.to(self.device)
        return self

    def load_anim_nerf(self, groups: dict) -> None:
        """groups: {"nerf": state dict, "nerf_fine": state dict}."""
        self.scene.nerf.load_state_dict(groups["nerf"])
        if self.scene.nerf_fine is not None:
            self.scene.nerf_fine.load_state_dict(groups["nerf_fine"])

    def load_params(self, params: dict) -> None:
        """params: {"anim_nerf": {...}, "body_params": {name: tensor}}, as
        ``utils/convert.py::params_from_jax`` returns them."""
        self.load_anim_nerf(params["anim_nerf"])
        with torch.no_grad():
            for k, v in params["body_params"].items():
                p = self.body_params[k]
                if tuple(p.shape) != tuple(v.shape):
                    raise ValueError(f"body param {k}: {tuple(v.shape)} "
                                     f"for {tuple(p.shape)}")
                p.copy_(v)
