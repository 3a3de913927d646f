"""Mesh extraction CLI of the port — counterpart of
``animnerf_tpu/cli/extract_mesh.py``:

    python -m animnerf_tpu_torch.cli.extract_mesh --ckpt_path <dir>
        [--device cpu] [--N_grid 256] [--sigma_threshold 20] [--no_smooth]
        [--template] [--orig_pose] [--vis --n_views 120] [key value ...]

A dense N^3 density grid centred on the (root-frame) body, queried
through the unpose warp (``Renderer.query_sigma_observed``), so the mesh
is in the observed pose; relu(sigma) - threshold, smoothing, marching
tetrahedra (``ops/marching.py``), the grid -> world remap with the
reference's axis swap; OBJ files of the body model and of the mesh;
``--vis`` a raster turntable GIF of the mesh. Writes
``<outputs_dir>/<exp_name>/mesh_{frame|T}_{optim|orig}_pose/``. Runs on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np


def create_grid(N: int, x_range, y_range, z_range) -> np.ndarray:
    x = np.linspace(x_range[0], x_range[1], N)
    y = np.linspace(y_range[0], y_range[1], N)
    z = np.linspace(z_range[0], z_range[1], N)
    return np.stack(np.meshgrid(x, y, z), -1)  # (N, N, N, 3), xy swapped


def grid_to_world(vertices: np.ndarray, N: int, x_range, y_range,
                  z_range) -> np.ndarray:
    """Grid-index -> world coords incl. the meshgrid x/y swap
    (reference extract_mesh.py:37-47; it divides by N, not N - 1)."""
    v = vertices / N
    out = np.empty_like(v)
    out[:, 0] = (y_range[1] - y_range[0]) * v[:, 1] + y_range[0]
    out[:, 1] = (x_range[1] - x_range[0]) * v[:, 0] + x_range[0]
    out[:, 2] = (z_range[1] - z_range[0]) * v[:, 2] + z_range[0]
    return out


def mesh_grid(renderer, body_params: dict, template: dict, N: int,
              ranges):
    """(points (1, N^3, 3) float32, the body's centre (3,), the body's
    root-frame vertices (Vb, 3)): the N^3 grid of ``ranges`` (x, y, z)
    about the centre of the body's root-frame bounding box, made in
    float64, cast to float32, then moved to the centre."""
    ctx = renderer.frame_context(body_params, template)
    verts_rf = ctx.verts[0].cpu().numpy()
    center = (verts_rf.max(0) + verts_rf.min(0)) / 2.0
    grid = create_grid(N, *ranges)
    return grid.reshape(1, -1, 3).astype(np.float32) + center, center, verts_rf


def extract_mesh(renderer, body_params: dict, template: dict, N: int,
                 ranges, sigma_threshold: float, smooth_field: bool = True,
                 stats: Optional[dict] = None):
    """The mesh of the renderer's system in one pose -> (vertices (V, 3),
    faces (T, 3), root-frame body vertices (Vb, 3), the relu(sigma) grid
    (N, N, N)). ``ranges``: the x, y, z ranges of the grid about the
    body's centre. ``stats``, when given, collects host-clock seconds:
    ``grid_s`` (the grid's points), ``query_s`` (the query, its output on
    the host), ``smooth_s`` (threshold and smoothing), ``march_s``
    (marching and the remap)."""
    from animnerf_tpu_torch.ops.marching import marching_cubes, smooth

    t0 = time.perf_counter()
    points, center, verts_rf = mesh_grid(renderer, body_params, template, N,
                                         ranges)
    t1 = time.perf_counter()
    sigmas = renderer.query_sigma_observed(
        body_params, template, points,
        use_fine=renderer.system.scene_cfg.use_fine)
    t2 = time.perf_counter()
    sigmas = np.maximum(sigmas.reshape(N, N, N), 0)
    field = sigmas - sigma_threshold
    if smooth_field:
        field = smooth(field)
    t3 = time.perf_counter()
    # inside = field > 0; the marching treats below-iso as inside, so
    # negate (the reference calls marching_cubes(-smoothed, 0), :164-166)
    vertices, faces = marching_cubes(-field, 0.0)
    vertices = grid_to_world(vertices, N, *ranges) + center
    if stats is not None:
        stats.update(grid_s=t1 - t0, query_s=t2 - t1, smooth_s=t3 - t2,
                     march_s=time.perf_counter() - t3)
    return vertices, faces, verts_rf, sigmas


def main(argv=None, stats: Optional[dict] = None) -> str:
    """Run the CLI -> the output directory. ``stats``, when given, also
    collects ``save_s`` (``mesh.obj``), ``raster_s`` (each view of
    ``--vis``), ``n_verts`` and ``n_faces``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt_path", type=str, required=True)
    parser.add_argument("--cfg_file", type=str, default=None)
    parser.add_argument("--frame_id", type=int, default=1)
    parser.add_argument("--cam_id", type=int, default=0)
    parser.add_argument("--template", action="store_true")
    parser.add_argument("--orig_pose", action="store_true")
    parser.add_argument("--N_grid", type=int, default=256)
    parser.add_argument("--x_range", nargs="+", type=float, default=[-1.2, 1.2])
    parser.add_argument("--y_range", nargs="+", type=float, default=[-1.2, 1.2])
    parser.add_argument("--z_range", nargs="+", type=float, default=[-1.2, 1.2])
    parser.add_argument("--sigma_threshold", type=float, default=20.0)
    parser.add_argument("--dis_threshold", type=float, default=0.2)
    parser.add_argument("--no_smooth", action="store_true")
    parser.add_argument("--vis", action="store_true")
    parser.add_argument("--n_views", type=int, default=120)
    parser.add_argument("--device", default=None, type=str,
                        help="'cpu' for the plain versions on the CPU; "
                             "the card by default")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    import torch

    import animnerf_tpu_torch.smpl.body_model as bm
    from animnerf_tpu_torch.cli.common import (
        load_cam_and_rays,
        load_frame_params,
        load_system_and_params,
        optimized_frame_params,
        resolve_cfg,
    )
    from animnerf_tpu_torch.models.warp import affine_inverse
    from animnerf_tpu_torch.render.inference import Renderer
    from animnerf_tpu_torch.utils.io import save_obj

    cfg = resolve_cfg(args.ckpt_path, args.cfg_file, args.opts)
    cfg.dis_threshold = args.dis_threshold
    system = load_system_and_params(cfg, args.ckpt_path, args.device)
    dev = system.device
    stats = {} if stats is None else stats

    tag = "T" if args.template else str(args.frame_id)
    pose_tag = ("optim_pose" if not args.orig_pose and cfg.optim_body_params
                else "orig_pose")
    save_dir = os.path.join(cfg.outputs_dir, cfg.exp_name,
                            f"mesh_{tag}_{pose_tag}")
    os.makedirs(save_dir, exist_ok=True)

    frame_idx, body_params, template = load_frame_params(cfg, args.frame_id,
                                                         dev)
    if not args.orig_pose:
        body_params = optimized_frame_params(cfg, system, frame_idx,
                                             body_params)
    if args.template:  # full template body (reference extract_mesh.py:136-141)
        body_params = dict(template)

    ranges = (args.x_range, args.y_range, args.z_range)
    vertices, faces, verts_rf, _ = extract_mesh(
        Renderer(system, device=dev), body_params, template, args.N_grid,
        ranges, args.sigma_threshold, not args.no_smooth, stats)
    save_obj(os.path.join(save_dir, "smpl.obj"), verts_rf,
             system.body_model.faces)
    mesh_path = os.path.join(save_dir, "mesh.obj")
    t0 = time.perf_counter()
    save_obj(mesh_path, vertices, faces)
    stats.update(save_s=time.perf_counter() - t0, n_verts=len(vertices),
                 n_faces=len(faces))
    print(f"Saved to {mesh_path} ({len(vertices)} verts, {len(faces)} tris)")

    if args.vis:
        from animnerf_tpu_torch.utils.image import write_gif, write_png
        from animnerf_tpu_torch.utils.renderer import SoftwareRenderer

        os.makedirs(os.path.join(save_dir, "images"), exist_ok=True)
        cam, _ = load_cam_and_rays(cfg, args.cam_id, device="cpu")
        H, W = cam["height"], cam["width"]
        raster = SoftwareRenderer((H, W))
        R = np.asarray(cam["R"], np.float64)
        t = np.asarray(cam["t"], np.float64).reshape(3)
        # camera rebased into the root frame (reference :183-190)
        with torch.no_grad():
            g_inv = affine_inverse(bm.forward(
                system.body_model, **body_params).joints_transform[:, 0])
        g_inv = g_inv[0].cpu().numpy()
        R = g_inv[:3, :3] @ R
        t = g_inv[:3, 3] + t
        raster.set_camera(cam["camera_f"][0], cam["camera_f"][1],
                          cam["camera_c"][0], cam["camera_c"][1], R, t)
        frames = []
        for i in range(args.n_views):
            t0 = time.perf_counter()
            img = raster.render(vertices, faces,
                                angle=-i / args.n_views * 360, axis=[0, 1, 0])
            stats.setdefault("raster_s", []).append(time.perf_counter() - t0)
            write_png(os.path.join(save_dir, "images", f"{i:06d}.png"), img)
            frames.append(img)
        write_gif(os.path.join(save_dir, "3d_rec.gif"), frames, fps=30)
        print(f"Saved to {os.path.join(save_dir, '3d_rec.gif')}")
    return save_dir


if __name__ == "__main__":
    main()
