"""360-degree turntable novel-view CLI of the port — counterpart of
``animnerf_tpu/cli/novel_view.py``:

    python -m animnerf_tpu_torch.cli.novel_view --ckpt_path <dir>
        [--device cpu] [--frame_id 1] [--cam_id 0] [--template]
        [--orig_pose] [--betas_2th 0.5] [--n_views 120] [--angle 0]
        [key value ...]

Renders the frame's optimised pose (``--orig_pose``: the pkl pose;
``--template``: the template's T-pose), with ``--betas_2th`` added to the
second shape coefficient, from ``--n_views`` angles of a turntable about
the body (``Renderer.render_stream`` with ``turntable_rotation``). Writes
``<outputs_dir>/<exp_name>/novel_view_{frame|T}_{optim|orig}_pose_{angle}/``
with ``images/``, ``depths/`` (PNG) and ``novel_view.gif``. Runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional


def main(argv=None, stats: Optional[dict] = None) -> str:
    """Run the CLI -> the output directory. ``stats``, when given,
    collects host-clock seconds: ``view_s`` (each view rendered, its
    outputs on the host) and ``gif_s`` (the GIF's encode and write)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt_path", type=str, required=True)
    parser.add_argument("--cfg_file", type=str, default=None)
    parser.add_argument("--frame_id", type=int, default=1)
    parser.add_argument("--cam_id", type=int, default=0)
    parser.add_argument("--template", action="store_true",
                        help="render the canonical template pose")
    parser.add_argument("--orig_pose", action="store_true",
                        help="use the pkl pose instead of the optimized one")
    parser.add_argument("--dis_threshold", type=float, default=0.2)
    parser.add_argument("--betas_2th", type=float, default=0,
                        help="offset added to the 2nd shape coefficient")
    parser.add_argument("--n_views", type=int, default=120)
    parser.add_argument("--angle", type=int, default=0)
    parser.add_argument("--device", default=None, type=str,
                        help="'cpu' for the plain versions on the CPU; "
                             "the card by default")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    import time

    import numpy as np

    from animnerf_tpu_torch.cli.common import (
        load_cam_and_rays,
        load_frame_params,
        load_system_and_params,
        optimized_frame_params,
        resolve_cfg,
    )
    from animnerf_tpu_torch.render.inference import (
        Renderer,
        turntable_rotation,
    )
    from animnerf_tpu_torch.utils.image import write_gif
    from animnerf_tpu_torch.utils.vis import (
        colorize_depth,
        save_image,
        to_uint8,
    )

    cfg = resolve_cfg(args.ckpt_path, args.cfg_file, args.opts)
    cfg.dis_threshold = args.dis_threshold
    system = load_system_and_params(cfg, args.ckpt_path, args.device)
    dev = system.device

    tag = "T" if args.template else str(args.frame_id)
    pose_tag = "orig_pose" if args.orig_pose else "optim_pose"
    save_dir = os.path.join(cfg.outputs_dir, cfg.exp_name,
                            f"novel_view_{tag}_{pose_tag}_{args.angle}")
    os.makedirs(os.path.join(save_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(save_dir, "depths"), exist_ok=True)

    frame_idx, body_params, template = load_frame_params(cfg, args.frame_id,
                                                         dev)
    if not args.orig_pose:
        body_params = optimized_frame_params(cfg, system, frame_idx,
                                             body_params)
    if args.template:  # T-pose view (reference novel_view.py:186-187)
        body_params = dict(body_params, body_pose=template["body_pose"])
    if args.betas_2th:  # shape editing (reference :189)
        betas = body_params["betas"].clone()
        betas[:, 1] += args.betas_2th
        body_params = dict(body_params, betas=betas)

    cam, rays = load_cam_and_rays(cfg, args.cam_id, device=dev)
    W, H = cfg.img_wh

    renderer = Renderer(system, device=dev)
    frames = []
    stream = renderer.render_stream(
        dict(body_params=body_params, body_tmpl=template, rays=rays,
             P=turntable_rotation(i, args.n_views, args.angle),
             img_wh=(W, H))
        for i in range(args.n_views))
    t0 = time.perf_counter()
    for i, (img, mask, depth) in enumerate(stream):
        if stats is not None:
            stats.setdefault("view_s", []).append(time.perf_counter() - t0)
        depth_vis = colorize_depth(depth)
        save_image(os.path.join(save_dir, "images", f"{i:06d}.png"), img)
        save_image(os.path.join(save_dir, "depths", f"{i:06d}.png"), depth_vis)
        frames.append(np.concatenate([to_uint8(img), depth_vis], axis=1))
        print(f"view {i + 1}/{args.n_views}", flush=True)
        t0 = time.perf_counter()

    gif = os.path.join(save_dir, "novel_view.gif")
    t0 = time.perf_counter()
    write_gif(gif, frames, fps=30)
    if stats is not None:
        stats["gif_s"] = time.perf_counter() - t0
    print(f"Saved to {gif}")
    return save_dir


if __name__ == "__main__":
    main()
