"""Evaluation CLI of the port: full-frame renders of a split, the mean
PSNR and SSIM; ``--vis`` saves GT | prediction | depth triptychs.

    python -m animnerf_tpu_torch.cli.test --ckpt_path <dir> [--device cpu]
        [--cfg_file <yaml>] [--split test] [--vis] [key value ...]

The config is the checkpoint's (``meta.json["cfg"]``), then the YAML file,
then the options. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional


def resolve_cfg(ckpt_path: str, cfg_file: Optional[str] = None,
                opts: Optional[list] = None):
    """Checkpoint-stored cfg, then the YAML file, then the options."""
    from animnerf_tpu_torch.config import finalize, get_default_config
    from animnerf_tpu_torch.training.checkpoints import load_metadata

    if not os.path.exists(ckpt_path):
        raise FileNotFoundError(f"checkpoint not found: {ckpt_path!r}")
    cfg = get_default_config()
    cfg.merge_from_dict(load_metadata(ckpt_path).get("cfg", {}))
    if cfg_file:
        cfg.merge_from_file(cfg_file)
    if opts:
        cfg.merge_from_list(opts)
    return finalize(cfg)


def main(argv=None) -> dict:
    from animnerf_tpu_torch.training.loop import evaluate

    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt_path", type=str, required=True)
    parser.add_argument("--cfg_file", type=str, default=None,
                        help="config; defaults to the one stored in the ckpt")
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--vis", action="store_true")
    parser.add_argument("--device", default=None, type=str,
                        help="'cpu' for the plain versions on the CPU; "
                             "the card by default")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = resolve_cfg(args.ckpt_path, args.cfg_file, args.opts)
    out_dir = os.path.join(cfg.outputs_dir, cfg.exp_name)
    means = evaluate(cfg, args.ckpt_path, split=args.split,
                     save_vis=args.vis, out_dir=out_dir, device=args.device)
    for k, v in means.items():
        print(f"{k}: {v:.4f}")
    return means


if __name__ == "__main__":
    main()
