"""Template preparation: mean shape, X-pose and a signed-distance point
cloud — counterpart of ``animnerf_tpu/tools/prepare_template.py``.

Mean betas over the per-frame pickles, the X-pose from a pickle
(betas / global_orient / body_pose / transl), the template mesh through
the port's body model, ``num_points`` uniform points in the
(2, 2, 5)-scaled box of the mesh (drawn with ``np.random.default_rng(seed)``
as the JAX tool draws them), their signed distances to the mesh
(``ops/mesh_distance.py``, inside negative, on the card unless the CPU is
asked for), all written to ``{model_type}_template.pkl`` with the JAX
tool's keys and dtypes.

    python -m animnerf_tpu_torch.tools.prepare_template \
        --data_root data/people_snapshot --people_ID male-3-casual \
        --gender male --model_path smplx/models --template_path assets/X_pose.pkl
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from animnerf_tpu_torch.ops.mesh_distance import signed_distance
from animnerf_tpu_torch.smpl import body_model as bm
from animnerf_tpu_torch.smpl.loader import load_pickle
from animnerf_tpu_torch.utils.device import DeviceLike, resolve_device
from animnerf_tpu_torch.utils.io import write_pickle_file

BOX_SCALE = (2.0, 2.0, 5.0)


def template_points(verts: np.ndarray, num_points: int, seed: int = 0):
    """(center, bbox (2, 3), points (num_points, 3) float64) of the mesh's
    (2, 2, 5)-scaled box, uniform from ``default_rng(seed)``."""
    orig_bbox = np.stack([verts.min(0), verts.max(0)])
    center = orig_bbox.mean(0)
    scale = np.array(BOX_SCALE)
    dxyz = orig_bbox[1] - orig_bbox[0]
    bbox = np.stack([center - dxyz * scale / 2, center + dxyz * scale / 2])
    rng = np.random.default_rng(seed)
    points = rng.random((num_points, 3))
    return center, bbox, points * (bbox[1] - bbox[0]) + bbox[0]


def prepare_template(data_root: str, people_ID: str, gender: str = "male",
                     model_path: str = "smplx/models",
                     model_type: str = "smpl",
                     template_path: str = "assets/X_pose.pkl",
                     num_points: int = 64 ** 3, chunk=None, seed: int = 0,
                     device: DeviceLike = None) -> str:
    """Write ``{data_root}/{people_ID}/{model_type}_template.pkl`` and
    return its path. ``chunk`` points a distance chunk (by default sized
    by memory, ``ops/mesh_distance.py::chunk_points``)."""
    dev = resolve_device(device)
    model = bm.create(model_path, model_type, gender)

    params_dir = os.path.join(data_root, people_ID, f"{model_type}s")
    frame_files = sorted(os.listdir(params_dir))
    betas = np.stack([
        np.asarray(load_pickle(os.path.join(params_dir, f))["betas"],
                   np.float32).reshape(-1)[:10]
        for f in frame_files
    ]).mean(0)

    tmpl = load_pickle(template_path)
    pose_dim = 69 if model_type == "smpl" else 63
    body_pose = np.asarray(tmpl["body_pose"], np.float32).reshape(-1)[
        :pose_dim]
    global_orient = np.asarray(tmpl["global_orient"], np.float32).reshape(-1)
    transl = np.asarray(tmpl["transl"], np.float32).reshape(-1)
    with torch.no_grad():
        verts = bm.forward(
            model, betas=torch.from_numpy(betas)[None],
            global_orient=torch.from_numpy(global_orient)[None],
            body_pose=torch.from_numpy(body_pose)[None],
            transl=torch.from_numpy(transl)[None]).vertices[0].numpy()

    center, bbox, points = template_points(verts, num_points, seed)
    distances = signed_distance(points, verts, model.faces, chunk=chunk,
                                device=dev).cpu().numpy()

    out = {
        "betas": betas,
        "body_pose": body_pose,
        "global_orient": global_orient,
        "transl": transl,
        "model_type": model_type,
        "gender": gender,
        "verts": verts,
        "faces": model.faces,
        "center": center,
        "bbox": bbox,
        "points": points.astype(np.float32),
        "distances": distances.astype(np.float32),
    }
    path = os.path.join(data_root, people_ID, f"{model_type}_template.pkl")
    write_pickle_file(path, out)
    print(f"wrote {path} ({(distances < 0).sum()} inside / "
          f"{(distances > 0).sum()} outside points)")
    return path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", type=str, default="data/people_snapshot")
    parser.add_argument("--people_ID", type=str, default="male-3-casual")
    parser.add_argument("--gender", type=str, default="male")
    parser.add_argument("--model_path", type=str, default="smplx/models")
    parser.add_argument("--model_type", type=str, default="smpl")
    parser.add_argument("--template_path", type=str, default="assets/X_pose.pkl")
    parser.add_argument("--num_points", type=int, default=64 ** 3)
    parser.add_argument("--chunk", type=int, default=None,
                        help="points a distance chunk (default: by memory)")
    parser.add_argument("--device", type=str, default=None,
                        help="'cpu' to run on the CPU (default: the card)")
    args = parser.parse_args(argv)
    prepare_template(args.data_root, args.people_ID, args.gender,
                     args.model_path, args.model_type, args.template_path,
                     args.num_points, args.chunk, device=args.device)


if __name__ == "__main__":
    main()
