"""AnimNeRF system — counterpart of
``animnerf_tpu/training/system.py::AnimNeRFSystem``.

Builds ``scene_cfg`` (``AnimNeRFConfig``), ``renderer_cfg``
(``RendererConfig``), the training options (``train_cfg``, the reference's
``train`` section) and the scene model from a config dict with the
reference's keys (a checkpoint's ``meta.json["cfg"]`` is one) over
``config.py::get_default_config()``, and holds
the body model, the learnable per-frame body parameters and, with
``deformation_dim`` / ``apperance_dim``, the per-frame latent codes.
Every option of the reference's YAML is taken. Parameters live in the
``nn.Module`` tree; load them with ``load_anim_nerf`` or ``load_params``
(see ``utils/convert.py``). ``render`` renders a ray batch as the JAX
package's ``AnimNeRFSystem.render`` does: the rows path for the flagship
configuration (``rows_renderable``) without codes, ``render_rays_split``
for every other. The training and evaluation steps take the system:
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
    render_rays_split,
)
from animnerf_tpu_torch.smpl.body_model import BodyModel
from animnerf_tpu_torch.utils.device import DeviceLike, resolve_device

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


# rays a step at and below which "auto" keeps the plain MLP's activations
# (the JAX package's TPU rule, training/system.py:56-83)
REMAT_RAYS = 16384


def resolve_remat(value, c: CfgNode, device) -> bool:
    """'auto' recomputes the plain MLP in the backward on the CPU, and on
    the card above REMAT_RAYS rays a step (the JAX package's rule per
    backend, the card in the TPU's place, as for compute_dtype); a string
    from the command line reads as a bool."""
    if value == "auto":
        if device.type != "cuda":
            return True
        return int(c.train.batch_size) * int(c.train.subsamplesize) ** 2 \
            > REMAT_RAYS
    if isinstance(value, str):
        return value.lower() in ("true", "1", "yes")
    return bool(value)


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
        k_neigh = int(c.k_neigh)
        if k_neigh < 1:  # the kNN takes any k from 1 to the vertex count
            raise ValueError(f"k_neigh must be at least 1, got {k_neigh}")
        n_fine, n_depth = int(c.n_importance), int(c.n_depth)
        self.scene_cfg = AnimNeRFConfig(
            freqs_xyz=int(c.freqs_xyz),
            freqs_dir=int(c.freqs_dir),
            use_view=bool(c.use_view),
            use_unpose=bool(c.use_unpose),
            unpose_view=bool(c.unpose_view),
            k_neigh=k_neigh,
            use_deformation=bool(c.use_deformation),
            deformation_dim=int(c.deformation_dim),
            apperance_dim=int(c.apperance_dim),
            use_fine=n_fine > 0 or n_depth > 0,
            share_fine=bool(c.share_fine),
            dis_threshold=float(c.dis_threshold),
            query_inside=bool(c.query_inside),
            compute_dtype=resolve_compute_dtype(str(c.compute_dtype), dev),
            remat=resolve_remat(c.get("remat", "auto"), c, dev),
            fused_mlp=str(c.get("fused_mlp", "auto")),
        )
        self.renderer_cfg = RendererConfig(
            n_coarse=int(c.n_samples), n_fine=n_fine, n_fine_depth=n_depth,
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
        # per-frame codes, N(0, 0.1) as the reference (train.py:133-137)
        self.latent_dim = self.scene_cfg.deformation_dim \
            + self.scene_cfg.apperance_dim
        self.latent_codes = None
        if self.latent_dim > 0:
            self.latent_codes = nn.Parameter(0.1 * torch.randn(
                c.num_frames, self.latent_dim, generator=gen))
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
        """groups: {"nerf": state dict, "nerf_fine": state dict, "derf":
        state dict}, each net the system has."""
        for net in ("nerf", "nerf_fine", "derf"):
            module = getattr(self.scene, net)
            if module is not None:
                module.load_state_dict(groups[net])

    def load_params(self, params: dict) -> None:
        """params: {"anim_nerf": {...}, "body_params": {name: tensor},
        optionally "latent_codes": (num_frames, dim) tensor}, as
        ``utils/convert.py::params_from_jax`` returns them."""
        self.load_anim_nerf(params["anim_nerf"])
        if params.get("latent_codes") is not None:
            if self.latent_codes is None or tuple(
                    self.latent_codes.shape) != tuple(
                    params["latent_codes"].shape):
                raise ValueError("latent_codes "
                                 f"{tuple(params['latent_codes'].shape)} "
                                 "do not fit the system")
            with torch.no_grad():
                self.latent_codes.copy_(params["latent_codes"])
        with torch.no_grad():
            for k, v in params["body_params"].items():
                p = self.body_params[k]
                if tuple(p.shape) != tuple(v.shape):
                    raise ValueError(f"body param {k}: {tuple(v.shape)} "
                                     f"for {tuple(p.shape)}")
                p.copy_(v)

    def codes(self, frame_idx: Optional[torch.Tensor]):
        """(deformation_code, apperance_code) of the frames (B,) or None:
        rows of ``latent_codes`` at max(frame_idx, 0), split at
        deformation_dim (JAX ``_codes``)."""
        d_code = a_code = None
        if self.latent_dim > 0 and frame_idx is not None:
            codes = self.latent_codes[torch.clamp_min(
                frame_idx.to(torch.int64), 0)]
            dd = self.scene_cfg.deformation_dim
            if dd > 0:
                d_code = codes[:, :dd]
            if self.scene_cfg.apperance_dim > 0:
                a_code = codes[:, dd:dd + self.scene_cfg.apperance_dim]
        return d_code, a_code

    def rows_renderable(self) -> bool:
        """The rows render covers the flagship configuration
        (``AnimNeRFModel.rows_path_ok``) with up to 128 samples a ray
        (the lane permute's lanes); every other takes render_rays_split."""
        r = self.renderer_cfg
        return (self.scene.rows_path_ok
                and r.n_coarse + r.n_fine + r.n_fine_depth <= LANES)

    def render(self, body_params: dict, body_params_template: dict,
               rays: torch.Tensor, frame_idx: Optional[torch.Tensor] = None,
               perturb: float = 0.0, noise=None):
        """Render a ray batch (B, R, 8) -> (dict of (B, R, C) outputs, the
        frame context): the body model for both param sets, the rays in the
        root frame, then, as the JAX package picks: ``render_rays_rows``
        through the scene's rows hooks for a rows-renderable configuration
        without codes, ``render_rays_split`` through its point hooks (with
        the frames' codes) otherwise. ``perturb`` > 0
        (the dense training loss) reads ``noise`` (a ``TrainNoise``); the
        depth-guided samples read its ``depth_n`` at any perturb."""
        ctx = prepare_frame(self.body_model, body_params,
                            body_params_template)
        rays_root = rays_to_root_frame(ctx, rays)
        d_code, a_code = self.codes(frame_idx)
        scene = self.scene
        if d_code is None and a_code is None and self.rows_renderable():
            out = render_rays_rows(
                self.renderer_cfg, lambda rows: scene.warp_rows(ctx, rows),
                scene.field_rows, rays_root, perturb, noise)
            return out, ctx

        def warp_fn(xyz, viewdir):
            return scene.warp_points(ctx, xyz, viewdir)

        def field_fn(xyz, viewdir, valid, use_fine):
            return scene.field_points(xyz, viewdir, valid, use_fine,
                                      d_code, a_code)

        out = render_rays_split(self.renderer_cfg, warp_fn, field_fn,
                                rays_root, perturb, noise)
        return out, ctx
