"""AnimNeRF system — counterpart of
``animnerf_tpu/training/system.py::AnimNeRFSystem``.

Builds ``scene_cfg`` (``AnimNeRFConfig``), ``renderer_cfg``
(``RendererConfig``), the training options (``train_cfg``, the reference's
``train`` section) and the scene model from a config dict with the
reference's keys (a checkpoint's ``meta.json["cfg"]`` is one) over
``config.py::get_default_config()``, and holds
the body model and the learnable per-frame body parameters. Parameters
live in the ``nn.Module`` tree; load them with ``load_anim_nerf`` or
``load_params`` (see ``utils/convert.py``). ``render`` is the dense
rows render of a ray batch (``AnimNeRFSystem.render`` of the JAX package
on its rows path). The training and evaluation steps take the system:
``training/system.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from animnerf_tpu_torch.config import CfgNode, finalize, get_default_config
from animnerf_tpu_torch.models.anim_nerf import AnimNeRFConfig, AnimNeRFModel
from animnerf_tpu_torch.models.body_params import init_body_params
from animnerf_tpu_torch.models.warp import prepare_frame, rays_to_root_frame
from animnerf_tpu_torch.ops.sort_lanes import LANES
from animnerf_tpu_torch.render.volume_renderer import (
    RendererConfig,
    render_rays_rows,
)
from animnerf_tpu_torch.smpl.body_model import BodyModel
from animnerf_tpu_torch.utils.device import DeviceLike, resolve_device


# config values the port does not cover yet, and the value it supports
UNPORTED = {"use_view": False, "use_deformation": False,
            "deformation_dim": 0, "apperance_dim": 0, "use_unpose": True,
            "unpose_view": False, "n_depth": 0}
# k_neigh: the kNN kernels are instantiated for 1..16 neighbours
MAX_K_NEIGH = 16


def full_config(cfg: dict) -> CfgNode:
    """cfg over ``get_default_config()`` (sections merged key by key, the
    same coercion as a YAML merge), with the derived fields of
    ``finalize``; a ``num_frames`` given in cfg wins over the training
    frame range's length."""
    given = {k: v for k, v in cfg.items() if k not in ("frame_IDs",
                                                       "num_frames")}
    out = get_default_config()
    out.merge_from_dict(given)
    out = finalize(out)
    if cfg.get("num_frames") is not None:
        out.num_frames = int(cfg["num_frames"])
    return out


def num_frames(cfg: dict) -> int:
    """The count of per-frame body parameters: cfg["num_frames"] when
    given, else the length of the training frame range (``finalize``)."""
    return full_config(cfg).num_frames


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
        c = full_config(cfg)
        bad = [f"{k}={c[k]!r}" for k, want in UNPORTED.items()
               if c[k] != want]
        if bad:
            raise NotImplementedError(
                "not ported yet (the port covers the flagship field): "
                f"{', '.join(bad)}")
        k_neigh = int(c.k_neigh)
        if not 1 <= k_neigh <= MAX_K_NEIGH:
            raise NotImplementedError(
                f"k_neigh={k_neigh}: the port's kNN kernels take 1 to "
                f"{MAX_K_NEIGH} neighbours")
        n_fine = int(c.n_importance)
        self.scene_cfg = AnimNeRFConfig(
            freqs_xyz=int(c.freqs_xyz),
            use_fine=n_fine > 0,
            share_fine=bool(c.share_fine),
            dis_threshold=float(c.dis_threshold),
            k_neigh=k_neigh,
            query_inside=bool(c.query_inside),
            compute_dtype=resolve_compute_dtype(str(c.compute_dtype), dev),
        )
        self.renderer_cfg = RendererConfig(
            n_coarse=int(c.n_samples), n_fine=n_fine,
            white_bkgd=bool(c.white_bkgd),
            share_fine=self.scene_cfg.share_fine)
        self.cfg = c
        self.train_cfg = c.train
        self.model_type = str(c.model_type)
        self.optim_body_params = bool(c.optim_body_params)
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        self.scene = AnimNeRFModel(self.scene_cfg, generator=gen)
        self.body_model = body_model
        # body_pose is the config's pose_dim wide when the caller names
        # one, else the family's width (the default config's 69 is SMPL's)
        self.body_params = nn.ParameterDict({
            k: nn.Parameter(v) for k, v in init_body_params(
                c.num_frames, self.model_type,
                pose_dim=cfg.get("pose_dim")).items()})
        self.to_device(dev)

    def to_device(self, device) -> "AnimNeRFSystem":
        self.device = resolve_device(device)
        self.to(self.device)
        self.body_model = self.body_model.to(self.device)
        return self

    def set_body_params(self, params: dict) -> None:
        """Replace the per-frame body parameters ({name: (F, dim) tensor},
        e.g. ``models/body_params.py::load_body_params_from_dataset``);
        their shapes come from the data, as in the JAX package's fit."""
        self.body_params = nn.ParameterDict({
            k: nn.Parameter(torch.as_tensor(v, dtype=torch.float32).to(
                self.device).clone()) for k, v in params.items()})

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

    def rows_renderable(self) -> bool:
        """The rows render sorts each ray's coarse and fine samples on
        the lane permute's 128 lanes; configs with more samples a ray need
        the split renderer, which is not ported."""
        r = self.renderer_cfg
        return r.n_coarse + r.n_fine <= LANES

    def render(self, body_params: dict, body_params_template: dict,
               rays: torch.Tensor, perturb: float = 0.0):
        """Render a ray batch (B, R, 8) -> (dict of (B, R, C) outputs, the
        frame context): the body model for both param sets, the rays in the
        root frame, then ``render_rays_rows`` through the scene's warp and
        field (every sample of every ray). Serving and evaluation:
        ``perturb`` must be 0."""
        if not self.rows_renderable():
            r = self.renderer_cfg
            raise NotImplementedError(
                f"{r.n_coarse} + {r.n_fine} samples per ray: the rows "
                f"render takes up to {LANES}; the split renderer is not "
                "ported")
        ctx = prepare_frame(self.body_model, body_params,
                            body_params_template)
        rays_root = rays_to_root_frame(ctx, rays)
        out = render_rays_rows(
            self.renderer_cfg, lambda rows: self.scene.warp_rows(ctx, rows),
            self.scene.field_rows, rays_root, perturb)
        return out, ctx
