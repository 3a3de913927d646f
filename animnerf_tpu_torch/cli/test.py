"""Evaluation CLI of the port: full-frame renders of a split, the mean
PSNR, SSIM and LPIPS (where its weights file exists:
``$ANIMNERF_LPIPS_WEIGHTS`` or ``assets/lpips_alex.npz``); ``--vis`` saves
GT | prediction | depth triptychs.

    python -m animnerf_tpu_torch.cli.test --ckpt_path <dir> [--device cpu]
        [--cfg_file <yaml>] [--split test] [--vis] [key value ...]

The config is the checkpoint's (``meta.json["cfg"]``), then the YAML file,
then the options (``cli/common.py::resolve_cfg``). Runs on the card unless
``--device cpu`` is given; under torchrun (``WORLD_SIZE`` > 1) or with
``ANIMNERF_MULTIHOST`` set, on every rank (``evaluate`` splits each
frame's rays over them).
"""

from __future__ import annotations

import argparse
import os

from animnerf_tpu_torch.cli.common import resolve_cfg


def main(argv=None) -> dict:
    import torch.distributed as dist

    from animnerf_tpu_torch.parallel.mesh import (
        distributed_requested,
        init_distributed,
    )
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
    device = args.device
    if distributed_requested():
        device = init_distributed(args.device)
    try:
        means = evaluate(cfg, args.ckpt_path, split=args.split,
                         save_vis=args.vis, out_dir=out_dir, device=device)
        if not dist.is_initialized() or dist.get_rank() == 0:
            for k, v in means.items():
                print(f"{k}: {v:.4f}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return means


if __name__ == "__main__":
    main()
