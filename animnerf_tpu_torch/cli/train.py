"""Training CLI of the port:

    python -m animnerf_tpu_torch.cli.train --cfg_file <yaml> [--device cpu]
        [key value ...]

Trains per the config (``training/loop.py::fit``), then evaluates the
``last`` checkpoint on the test split. Runs on the card unless
``--device cpu`` is given. Refinement works as in the JAX package's CLI:
set ``train.ckpt_path`` and ``train.model_names_to_load ['anim_nerf']``
and the field loads frozen while the per-frame body params of the new
frames optimise.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    """--cfg_file, --device and the trailing ``key value`` options."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_file", default=None, type=str)
    parser.add_argument("--type", type=str, default="train")
    parser.add_argument("--device", default=None, type=str,
                        help="'cpu' for the plain versions on the CPU; "
                             "the card by default")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def main(argv=None) -> None:
    from animnerf_tpu_torch.config import finalize, get_default_config
    from animnerf_tpu_torch.training.loop import evaluate, fit

    args = parse_args(argv)
    cfg = get_default_config()
    if args.cfg_file:
        cfg.merge_from_file(args.cfg_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg = finalize(cfg)
    print(f"[animnerf_tpu_torch] training {cfg.exp_name} "
          f"({cfg.num_frames} frames @ {tuple(cfg.img_wh)})", flush=True)
    profile = bool(os.environ.get("ANIMNERF_PROFILE"))
    ckpt_dir = fit(cfg, profile=profile, device=args.device)
    print(f"[animnerf_tpu_torch] done; checkpoints in {ckpt_dir}",
          flush=True)
    last = os.path.join(ckpt_dir, "last")
    if os.path.exists(last):
        evaluate(cfg, last, split="test", device=args.device)


if __name__ == "__main__":
    main()
