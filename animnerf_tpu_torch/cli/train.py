"""Training CLI of the port:

    python -m animnerf_tpu_torch.cli.train --cfg_file <yaml> [--device cpu]
        [key value ...]

Trains per the config (``training/loop.py::fit``), then evaluates the
``last`` checkpoint on the test split. Runs on the card unless
``--device cpu`` is given. Refinement works as in the JAX package's CLI:
set ``train.ckpt_path`` and ``train.model_names_to_load ['anim_nerf']``
and the field loads frozen while the per-frame body params of the new
frames optimise.

On several GPUs, one process each (data parallelism: NCCL on the card,
gloo with ``--device cpu``):

    torchrun --standalone --nproc_per_node N -m animnerf_tpu_torch.cli.train \
        --cfg_file <yaml> [--device cpu] [key value ...]

Under torchrun (``WORLD_SIZE`` > 1), or with ``ANIMNERF_MULTIHOST`` set,
the process joins the process group before ``fit`` and leaves it at the
end (``parallel/mesh.py::init_distributed``).
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
    import torch.distributed as dist

    from animnerf_tpu_torch.parallel.mesh import (
        distributed_requested,
        init_distributed,
    )

    args = parse_args(argv)
    device = args.device
    if distributed_requested():
        device = init_distributed(args.device)
    try:
        run(args, device, rank=dist.get_rank() if dist.is_initialized()
            else 0)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(args, device, rank: int = 0) -> None:
    """fit, then evaluate ``last`` on the test split; rank 0 prints."""
    from animnerf_tpu_torch.config import finalize, get_default_config
    from animnerf_tpu_torch.parallel.mesh import broadcast_object, make_mesh
    from animnerf_tpu_torch.training.loop import evaluate, fit

    cfg = get_default_config()
    if args.cfg_file:
        cfg.merge_from_file(args.cfg_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg = finalize(cfg)
    if rank == 0:
        print(f"[animnerf_tpu_torch] training {cfg.exp_name} "
              f"({cfg.num_frames} frames @ {tuple(cfg.img_wh)})", flush=True)
    profile = bool(os.environ.get("ANIMNERF_PROFILE"))
    ckpt_dir = fit(cfg, profile=profile, device=device)
    if rank == 0:
        print(f"[animnerf_tpu_torch] done; checkpoints in {ckpt_dir}",
              flush=True)
    last = os.path.join(ckpt_dir, "last")
    # rank 0 wrote 'last': its answer holds for every rank
    if broadcast_object(make_mesh(device=device), os.path.exists(last)):
        evaluate(cfg, last, split="test", device=device)


if __name__ == "__main__":
    main()
