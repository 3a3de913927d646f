"""Configuration — counterpart of ``animnerf_tpu/config.py``.

The same field names, defaults and coercion rules, so the reference's
YAML files and the JAX package's checkpoints (``meta.json["cfg"]``) load
unchanged: a minimal attribute dict (``CfgNode``) with YAML-file merge and
dotted-key option merge. ``yaml`` is imported only by ``merge_from_file``;
configs built with ``merge_from_list`` / ``merge_from_dict`` need no YAML
package. ``mesh_shape`` is kept for the JAX package's configs and read
by neither package: training takes every rank of the process group that
divides the batch (``parallel/mesh.py::mesh_for_batch``).
"""

from __future__ import annotations

import argparse
import ast
import copy
from typing import Any, Iterable, Optional


class CfgNode(dict):
    """Attribute-style nested dict with type-checked merging."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    # ----------------------------------------------------------- merging

    @staticmethod
    def _coerce(new: Any, old: Any, key: str) -> Any:
        if old is None or new is None:
            return new
        if isinstance(old, CfgNode):
            raise TypeError(f"cannot replace config section {key!r} wholesale")
        if isinstance(old, bool):
            if isinstance(new, bool):
                return new
            if isinstance(new, str):
                return new.lower() in ("true", "1", "yes")
            return bool(new)
        if isinstance(old, (tuple, list)) and isinstance(new, str):
            new = ast.literal_eval(new)
        if isinstance(old, tuple) and isinstance(new, list):
            new = tuple(new)
        if isinstance(old, list) and isinstance(new, tuple):
            new = list(new)
        if isinstance(old, float) and isinstance(new, (int, str)):
            return float(new)
        if isinstance(old, int) and isinstance(new, str):
            return int(new)
        return new

    def merge_from_dict(self, other: dict, _path: str = "") -> None:
        for k, v in other.items():
            path = f"{_path}.{k}" if _path else k
            if k in self and isinstance(self[k], CfgNode):
                if not isinstance(v, dict):
                    raise TypeError(f"{path} must be a mapping")
                self[k].merge_from_dict(v, path)
            elif k in self:
                self[k] = self._coerce(v, self[k], path)
            else:
                self[k] = _wrap(v)

    def merge_from_file(self, path: str) -> None:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        self.merge_from_dict(data)

    def merge_from_list(self, opts: Iterable[str]) -> None:
        opts = list(opts)
        if len(opts) % 2 != 0:
            raise ValueError(f"opts must be key/value pairs, got {opts}")
        for key, raw in zip(opts[::2], opts[1::2]):
            node = self
            parts = key.split(".")
            try:
                for p in parts[:-1]:
                    node = node[p]
                if parts[-1] not in node:
                    raise KeyError
            except (KeyError, TypeError):
                raise KeyError(f"unknown config key {key!r}") from None
            leaf = parts[-1]
            old = node.get(leaf)
            try:
                val = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                val = raw
            node[leaf] = self._coerce(val, old, key)


def _wrap(v: Any) -> Any:
    if isinstance(v, dict):
        n = CfgNode()
        for k, vv in v.items():
            n[k] = _wrap(vv)
        return n
    return v


def get_default_config() -> CfgNode:
    """Defaults mirror the reference exactly (config.py:7-101)."""
    cfg = _wrap(
        {
            "num_gpus": -1,  # YAML compat; the port uses one device
            "exp_name": "male-3-casual",
            "dataset_name": "anim_nerf",
            "root_dir": "./data/male-3-casual",
            "model_type": "smpl",
            "gender": "male",
            "model_path": "./smplx/models",
            "checkpoints_dir": "./checkpoints",
            "logs_dir": "./logs",
            "outputs_dir": "./outputs",
            "img_wh": (512, 512),
            "freqs_xyz": 10,
            "freqs_dir": 4,
            "use_view": False,
            "use_knn": True,
            "k_neigh": 4,
            "use_unpose": True,
            "unpose_view": False,
            "use_deformation": False,
            "deformation_dim": 0,
            "apperance_dim": 0,
            "latent_dim": 0,
            "pose_dim": 69,
            "optim_body_params": True,
            "dis_threshold": 0.2,
            "n_samples": 64,
            "n_importance": 16,
            "n_depth": 0,
            "share_fine": False,
            "chunk": 2048,  # compat only: the TPU path renders unchunked
            "query_inside": False,
            "white_bkgd": True,
            # 'auto' is bfloat16 on the card (the fused MLP's fast path) and
            # float32 on the CPU (system.py::resolve_compute_dtype)
            "compute_dtype": "auto",
            # recompute the plain MLP in the backward: 'auto' is on on the
            # CPU and, on the card, above 16,384 rays a step
            # (system.py::resolve_remat)
            "remat": "auto",
            # kernel 3 for flagship-architecture fields ('auto' / 'on'),
            # the plain MLP for every field ('off')
            "fused_mlp": "auto",
            "mesh_shape": (-1,),  # not read, as in the JAX package
            "seed": 42,
            "train": {
                "frame_start_ID": 1,
                "frame_end_ID": 400,
                "frame_skip": 4,
                "cam_IDs": None,
                "subsampletype": "foreground_pixel",
                "subsamplesize": 32,
                "fore_rate": 0.9,
                "fore_erode": 3,
                "lambda_alphas": 0.1,
                "lambda_foreground": 0.01,
                "lambda_background": 0.01,
                "lambda_normals": 0.01,
                "lambda_cycle": 0.1,
                "epsilon": 0.01,
                "batch_size": 16,
                "max_epochs": 30,
                "max_steps": 200000,
                "lr": 5e-4,
                "optimizer": {"type": "adam", "momentum": 0.9,
                              "weight_decay": 0},
                "scheduler": {"type": "poly", "poly_exp": 0.9},
                "num_workers": 8,
                "save_top_k": 1,
                "save_last": True,
                "resume": False,
                "ckpt_path": None,
                "model_names_to_load": None,
                "pretrained_model_requires_grad": False,
                "strategy": "dp",  # compat only
                "log_every": 50,
            },
            "val": {
                "frame_start_ID": 400,
                "frame_end_ID": 500,
                "frame_skip": 4,
                "cam_IDs": None,
                "batch_size": 1,
                "num_workers": 8,
                "vis_freq": 20,
            },
            "test": {
                "frame_start_ID": 400,
                "frame_end_ID": 500,
                "frame_skip": 4,
                "cam_IDs": None,
                "batch_size": 1,
                "num_workers": 8,
                "vis_freq": 4,
            },
        }
    )
    return cfg


def finalize(cfg: CfgNode) -> CfgNode:
    """Derived fields (reference config.py:115-116)."""
    cfg.frame_IDs = list(
        range(cfg.train.frame_start_ID, cfg.train.frame_end_ID + 1,
              cfg.train.frame_skip)
    )
    cfg.num_frames = len(cfg.frame_IDs)
    return cfg


def get_cfg(argv: Optional[list[str]] = None) -> CfgNode:
    """CLI entry: --cfg_file YAML merge then trailing `key value` opts
    (reference config.py:103-118)."""
    cfg = get_default_config()
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_file", default=None, type=str)
    parser.add_argument("--type", type=str, default="train")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    if args.cfg_file:
        cfg.merge_from_file(args.cfg_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    return finalize(cfg)


def load_cfg_file(path: str, opts: Optional[list[str]] = None) -> CfgNode:
    cfg = get_default_config()
    cfg.merge_from_file(path)
    if opts:
        cfg.merge_from_list(opts)
    return finalize(cfg)
