"""Novel-pose animation CLI of the port, driven by Mixamo mocap —
counterpart of ``animnerf_tpu/cli/novel_pose.py``:

    python -m animnerf_tpu_torch.cli.novel_pose --ckpt_path <dir>
        [--device cpu] [--actions_dir mocap/mixamo/] [--action_type 0007]
        [--frame_skip 2] [--cam_id 0] [key value ...]

Reads ``<actions_dir>/<action_type>/result.pkl`` (``anim_len``,
``smpl_array``, ``cam_array``) and renders the trained subject in each
mocap pose with the trained betas and the mean trained ``transl`` plus the
mocap's in-plane offset. Writes ``<outputs_dir>/<exp_name>/
novel_pose_<action_type>/`` with ``images/``, ``masks/``, ``depths/``,
``smpls_vis/`` (the body model's vertices rastered by
``utils/renderer.py``) and ``novel_pose.gif``. Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional


def load_mixamo_smpl(actions_dir: str, action_type: str = "0007",
                     skip: int = 1) -> list[dict]:
    """Mocap pkl -> list of per-frame smpl dicts (reference :26-41)."""
    import numpy as np

    from animnerf_tpu_torch.smpl.loader import load_pickle

    result = load_pickle(os.path.join(actions_dir, action_type, "result.pkl"))
    anim_len = int(result["anim_len"])
    pose_array = np.asarray(result["smpl_array"], np.float32).reshape(anim_len, -1)
    cam_array = np.asarray(result["cam_array"], np.float32)
    mocap = []
    for i in range(0, anim_len, skip):
        mocap.append({
            "cam": cam_array[i],
            "global_orient": pose_array[i, :3],
            "body_pose": pose_array[i, 3:72],
            "transl": np.array([cam_array[i, 1], cam_array[i, 2], 0.0],
                               np.float32),
        })
    return mocap


def main(argv=None, stats: Optional[dict] = None) -> str:
    """Run the CLI -> the output directory. ``stats``, when given,
    collects host-clock seconds a frame: ``render_s`` (the frame rendered,
    its outputs on the host), ``body_s`` (the body model's forward and its
    vertices on the host) and ``raster_s`` (the overlay's raster)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt_path", type=str, required=True)
    parser.add_argument("--cfg_file", type=str, default=None)
    parser.add_argument("--actions_dir", type=str, default="mocap/mixamo/")
    parser.add_argument("--action_type", type=str, default="0007")
    parser.add_argument("--frame_id", type=int, default=1)
    parser.add_argument("--cam_id", type=int, default=0)
    parser.add_argument("--frame_skip", type=int, default=2)
    parser.add_argument("--dis_threshold", type=float, default=0.2)
    parser.add_argument("--device", default=None, type=str,
                        help="'cpu' for the plain versions on the CPU; "
                             "the card by default")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    import time

    import numpy as np
    import torch

    import animnerf_tpu_torch.smpl.body_model as bm
    from animnerf_tpu_torch.cli.common import (
        load_cam_and_rays,
        load_frame_params,
        load_system_and_params,
        resolve_cfg,
    )
    from animnerf_tpu_torch.render.inference import Renderer
    from animnerf_tpu_torch.utils.image import write_gif
    from animnerf_tpu_torch.utils.renderer import SoftwareRenderer
    from animnerf_tpu_torch.utils.vis import (
        colorize_depth,
        save_image,
        to_uint8,
    )

    cfg = resolve_cfg(args.ckpt_path, args.cfg_file, args.opts)
    cfg.dis_threshold = args.dis_threshold
    system = load_system_and_params(cfg, args.ckpt_path, args.device)
    dev = system.device

    save_dir = os.path.join(cfg.outputs_dir, cfg.exp_name,
                            f"novel_pose_{args.action_type}")
    for sub in ("images", "masks", "depths", "smpls_vis"):
        os.makedirs(os.path.join(save_dir, sub), exist_ok=True)

    _, _, template = load_frame_params(cfg, args.frame_id, dev)
    # betas/transl come from the *trained* store (reference :130-131)
    with torch.no_grad():
        betas = system.body_params["betas"][:1].detach().clone()
        transl_mean = system.body_params["transl"].detach().mean(
            dim=0, keepdim=True)

    cam, rays = load_cam_and_rays(cfg, args.cam_id, device=dev)
    W, H = cfg.img_wh
    raster = SoftwareRenderer((H, W))
    raster.set_camera(cam["camera_f"][0], cam["camera_f"][1],
                      cam["camera_c"][0], cam["camera_c"][1],
                      np.asarray(cam["R"], np.float64),
                      np.asarray(cam["t"], np.float64).reshape(3))

    mocap = load_mixamo_smpl(args.actions_dir, args.action_type,
                             args.frame_skip)
    renderer = Renderer(system, device=dev)
    pose_dim = cfg.get("pose_dim") or (69 if cfg.model_type == "smpl" else 63)

    def row(a):
        return torch.from_numpy(np.ascontiguousarray(a))[None].to(dev)

    all_body_params = [{
        "betas": betas,
        "global_orient": row(mc["global_orient"]),
        "body_pose": row(mc["body_pose"][:pose_dim]),
        "transl": transl_mean + row(mc["transl"]),
    } for mc in mocap]
    frames = []
    faces = np.asarray(system.body_model.faces)
    stream = renderer.render_stream(
        dict(body_params=bp, body_tmpl=template, rays=rays, img_wh=(W, H))
        for bp in all_body_params)
    t0 = time.perf_counter()
    for i, (img, mask, depth) in enumerate(stream):
        t1 = time.perf_counter()
        depth_vis = colorize_depth(depth)
        save_image(os.path.join(save_dir, "images", f"{i:06d}.png"), img)
        save_image(os.path.join(save_dir, "masks", f"{i:06d}.png"),
                   np.repeat(mask[..., None], 3, axis=-1))
        save_image(os.path.join(save_dir, "depths", f"{i:06d}.png"), depth_vis)

        t2 = time.perf_counter()
        with torch.no_grad():
            out = bm.forward(system.body_model, **all_body_params[i])
        verts = out.vertices[0].cpu().numpy()
        t3 = time.perf_counter()
        overlay = raster.render(verts, faces)
        t4 = time.perf_counter()
        save_image(os.path.join(save_dir, "smpls_vis", f"{i:06d}.png"), overlay)
        if stats is not None:
            for k, dt in (("render_s", t1 - t0), ("body_s", t3 - t2),
                          ("raster_s", t4 - t3)):
                stats.setdefault(k, []).append(dt)

        frames.append(np.concatenate([to_uint8(img), depth_vis], axis=1))
        print(f"mocap frame {i + 1}/{len(mocap)}", flush=True)
        t0 = time.perf_counter()

    gif = os.path.join(save_dir, "novel_pose.gif")
    write_gif(gif, frames, fps=30)
    print(f"Saved to {gif}")
    return save_dir


if __name__ == "__main__":
    main()
