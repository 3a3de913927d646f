"""Convert reference (PyTorch Lightning) checkpoints to the port's layout —
counterpart of ``animnerf_tpu/tools/convert_checkpoint.py``.

The reference stores one flat Lightning state_dict nesting ``anim_nerf.*``,
``latent_codes.*`` and ``body_model_params.*`` (with the evaluator's LPIPS
weights and the SMPL buffers). It is read without torch and without the
classes its hyper-parameters name (``utils/torch_pickle.py``) and written
by ``training/checkpoints.py::save_params`` as the JAX package writes it:
``anim_nerf.npz`` / ``latent_codes.npz`` / ``body_params.npz`` and
``meta.json`` with the hyper-parameters of plain types as ``cfg``.

Name map (a torch Linear weight (out, in) -> a flax kernel (in, out)):

    anim_nerf.nerf.xyz_encoding_{i}.0.weight  -> nerf/params/xyz_{i-1}/kernel
    anim_nerf.nerf.xyz_encoding_final.*       -> nerf/params/xyz_final/*
    anim_nerf.nerf.dir_encoding.0.*           -> nerf/params/dir_0/*
    anim_nerf.nerf.sigma.* / rgb.0.*          -> nerf/params/{sigma,rgb}/*
    anim_nerf.nerf_fine.*                     -> nerf_fine/params/...
    anim_nerf.derf.{xyz_encoding_{i}.0,out}.* -> derf/params/...
    latent_codes.weight                       -> latent_codes
    body_model_params.{p}.weight              -> body_params/{p}
    anim_nerf.body_model.* (SMPL buffers), evaluator.*, *.lpips* -> dropped

    python -m animnerf_tpu_torch.tools.convert_checkpoint \
        --ckpt_path checkpoints/male-3-casual/last.ckpt --out_dir converted
"""

from __future__ import annotations

import argparse

import numpy as np

from animnerf_tpu_torch.training.checkpoints import save_params
from animnerf_tpu_torch.utils.torch_pickle import load_torch_checkpoint

PLAIN_TYPES = (int, float, str, bool, list, tuple, dict, type(None))


def map_mlp_key(rest: str):
    """'xyz_encoding_3.0.weight' -> ('xyz_2', 'kernel'), etc.; KeyError
    for a layer outside the map."""
    parts = rest.split(".")
    layer, leaf = parts[0], parts[-1]
    flax_leaf = {"weight": "kernel", "bias": "bias"}[leaf]
    if layer.startswith("xyz_encoding_"):
        suffix = layer[len("xyz_encoding_"):]
        if suffix == "final":
            return "xyz_final", flax_leaf
        return f"xyz_{int(suffix) - 1}", flax_leaf
    if layer == "dir_encoding":
        return "dir_0", flax_leaf
    if layer in ("sigma", "rgb", "out"):
        return layer, flax_leaf
    raise KeyError(layer)


def convert_state_dict(state_dict: dict) -> dict:
    """Lightning state_dict (name -> numpy) -> the port's checkpoint
    groups {"anim_nerf": {"<net>/params/<layer>/<leaf>": array},
    "latent_codes": {"": array}, "body_params": {name: array}}, each
    group that has entries; arrays keep their dtype."""
    nerf: dict = {}
    body: dict = {}
    out: dict = {"anim_nerf": nerf}
    for name, value in state_dict.items():
        v = np.asarray(value)
        if name.startswith("anim_nerf.body_model.") or name.startswith(
                "evaluator.") or ".lpips" in name:
            continue
        if name.startswith("anim_nerf."):
            module, _, tail = name[len("anim_nerf."):].partition(".")
            if module not in ("nerf", "nerf_fine", "derf"):
                continue
            try:
                layer, leaf = map_mlp_key(tail)
            except KeyError:
                continue
            if leaf == "kernel":
                v = v.T  # torch (out, in) -> flax (in, out)
            nerf[f"{module}/params/{layer}/{leaf}"] = v
        elif name == "latent_codes.weight":
            out["latent_codes"] = {"": v}
        elif name.startswith("body_model_params."):
            body[name.split(".")[1]] = v
    if body:
        out["body_params"] = body
    return out


def convert(ckpt_path: str, out_dir: str) -> str:
    """Read a Lightning ``.ckpt`` and write the converted checkpoint
    directory; returns it."""
    raw = load_torch_checkpoint(ckpt_path)
    state_dict = raw.get("state_dict", raw)
    hparams = raw.get("hyper_parameters", {})
    params = convert_state_dict(state_dict)
    meta = {"source": ckpt_path}
    if isinstance(hparams, dict) and hparams:
        meta["cfg"] = {k: v for k, v in hparams.items()
                       if isinstance(v, PLAIN_TYPES)}
    save_params(out_dir, params, meta)
    print(f"converted {ckpt_path} -> {out_dir} "
          f"(groups: {sorted(params.keys())})")
    return out_dir


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt_path", type=str, required=True,
                        help="reference Lightning .ckpt file")
    parser.add_argument("--out_dir", type=str, required=True)
    args = parser.parse_args(argv)
    convert(args.ckpt_path, args.out_dir)


if __name__ == "__main__":
    main()
