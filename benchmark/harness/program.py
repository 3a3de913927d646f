"""The system under test: ``animnerf_tpu_torch``, built from a
configuration file, the rig arrays and the weights the benchmark made.
Only this module imports the program, and only when a run starts."""

from __future__ import annotations

import torch

from reference import field as fld

# the reference YAML's keys that the configuration file hands the program
PORT_KEYS = ("model_type", "gender", "freqs_xyz", "use_view", "k_neigh",
             "dis_threshold", "n_samples", "n_importance", "compute_dtype",
             "use_unpose", "optim_body_params", "white_bkgd")


def port_cfg(config: dict, num_frames: int) -> dict:
    cfg = {k: config[k] for k in PORT_KEYS if k in config}
    cfg["num_frames"] = num_frames
    cfg["pose_dim"] = 3 * (config["num_joints"] - 1) \
        if config["model_type"] == "smpl" else None
    cfg["train"] = {k: v for k, v in config["train"].items()
                    if k != "poly_exp"}
    cfg["train"]["scheduler"] = {"type": "poly",
                                 "poly_exp": config["train"]["poly_exp"]}
    if cfg["pose_dim"] is None:
        del cfg["pose_dim"]
    return cfg


def build_system(config: dict, rig: dict, weights: dict, device,
                 num_frames: int = 1, poses: dict = None):
    """AnimNeRFSystem on ``device`` with the benchmark's weights (and the
    per-frame body parameters ``poses``), its fields' widths checked
    against the configuration's."""
    from animnerf_tpu_torch.system import AnimNeRFSystem
    from animnerf_tpu_torch.utils.convert import body_model_from_arrays

    bm = body_model_from_arrays(**rig, model_type=config["model_type"])
    system = AnimNeRFSystem(port_cfg(config, num_frames), bm, device=device,
                            seed=0)
    shapes = fld.layer_shapes(config["arch"])
    groups = {}
    for net in ("nerf", "nerf_fine"):
        sd = {}
        for layer, shape in shapes.items():
            sd[f"{layer}.weight"] = weights[f"scene.{net}.{layer}.weight"]
            sd[f"{layer}.bias"] = weights[f"scene.{net}.{layer}.bias"]
            have = tuple(getattr(getattr(system.scene, net), layer)
                         .weight.shape)
            if have != shape:
                raise ValueError(f"the program's {net}.{layer} is {have}, "
                                 f"the configuration's {shape}")
        groups[net] = sd
    system.load_anim_nerf(groups)
    if poses is not None:
        system.set_body_params({k: v.detach().clone()
                                for k, v in poses.items()})
    return system


def make_trainer(system, steps_per_epoch: int):
    from animnerf_tpu_torch.training.system import make_trainer as mk

    return mk(system, steps_per_epoch=steps_per_epoch, seed=0, engine="auto")


def train_noise(noise: dict):
    from animnerf_tpu_torch.utils.rng import TrainNoise

    return TrainNoise(**noise)


def first_grads(trainer) -> dict:
    """The gradient of the first step as Adam holds it: exp_avg / (1 -
    beta1) after one update, by parameter name."""
    names = {id(p): n for n, p in trainer.system.named_parameters()}
    out = {}
    for group in trainer.optimizer.param_groups:
        b1 = group["betas"][0]
        for p in group["params"]:
            st = trainer.optimizer.state.get(p, {})
            out[names[id(p)]] = (st["exp_avg"] / (1 - b1)).detach().clone() \
                if "exp_avg" in st else torch.zeros_like(p)
    return out


def make_renderer(system, prepass: str):
    from animnerf_tpu_torch.render.inference import Renderer

    return Renderer(system, device=system.device, prepass=prepass)

