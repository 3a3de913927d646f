"""Inference-only AnimNeRF system — counterpart of the serving half of
``animnerf_tpu/training/system.py::AnimNeRFSystem``.

Builds ``scene_cfg`` (``AnimNeRFConfig``), ``renderer_cfg``
(``RendererConfig``) and the scene model from a config dict with the
reference's keys (a checkpoint's ``meta.json["cfg"]`` is one), and holds
the body model. Parameters live in the ``nn.Module`` tree; load them with
``load_anim_nerf`` (see ``utils/convert.py``).
"""

from __future__ import annotations

from torch import nn

from animnerf_tpu_torch.models.anim_nerf import AnimNeRFConfig, AnimNeRFModel
from animnerf_tpu_torch.render.volume_renderer import RendererConfig
from animnerf_tpu_torch.smpl.body_model import BodyModel
from animnerf_tpu_torch.utils.device import DeviceLike, resolve_device


# config values outside the serving slice, and the value the slice supports
UNPORTED = {"use_view": False, "use_deformation": False,
            "deformation_dim": 0, "apperance_dim": 0, "use_unpose": True,
            "unpose_view": False, "k_neigh": 4, "n_depth": 0}


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
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        g = cfg.get
        bad = [f"{k}={g(k)!r}" for k, want in UNPORTED.items()
               if k in cfg and g(k) != want]
        if bad:
            raise NotImplementedError(
                "not ported yet (the serving slice covers the flagship "
                f"field): {', '.join(bad)}")
        n_fine = int(g("n_importance", 32))
        self.scene_cfg = AnimNeRFConfig(
            freqs_xyz=int(g("freqs_xyz", 10)),
            use_fine=n_fine > 0,
            share_fine=bool(g("share_fine", False)),
            dis_threshold=float(g("dis_threshold", 0.2)),
            query_inside=bool(g("query_inside", False)),
            compute_dtype=resolve_compute_dtype(
                str(g("compute_dtype", "auto")), dev),
        )
        self.renderer_cfg = RendererConfig(
            n_coarse=int(g("n_samples", 64)), n_fine=n_fine,
            white_bkgd=bool(g("white_bkgd", True)))
        self.scene = AnimNeRFModel(self.scene_cfg)
        self.body_model = body_model
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
