"""VIBE output -> per-frame SMPL pickles and a camera — counterpart of
``animnerf_tpu/tools/convert_vibe.py`` (reference
tools/convert_vibe.py:22-75).

A fixed focal length f = 2000, the principal point ``[H // 2, W // 2]``
as the reference writes it, identity extrinsics, and per frame the
translation ``[cam_x, cam_y, 2 f / (cam_s H)]`` in float32 from VIBE's
weak-perspective ``orig_cam``; the keys, dtypes and file names of the
JAX tool. The image size comes from ``cam000/images/000001.png`` through
``utils/image.py::read_png`` (no OpenCV). ``vibe_output.pkl`` is read
with ``joblib`` where it is installed, else with the forgiving pickle
loader of ``smpl/loader.py``.

    python -m animnerf_tpu_torch.tools.convert_vibe --data_root data/iper \
        --people_ID iper_023_1_1 --gender neutral
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from animnerf_tpu_torch.utils.image import read_png
from animnerf_tpu_torch.utils.io import write_pickle_file


def load_vibe_output(path: str):
    try:
        import joblib
    except ImportError:
        from animnerf_tpu_torch.smpl.loader import load_pickle

        return load_pickle(path)
    return joblib.load(path)


def convert(data_root: str, people_ID: str, gender: str = "neutral",
            focal: float = 2000.0, track_id: int = 1) -> None:
    images_dir = os.path.join(data_root, people_ID, "cam000", "images")
    smpls_dir = os.path.join(data_root, people_ID, "smpls")
    if os.path.exists(smpls_dir):
        shutil.rmtree(smpls_dir)
    os.makedirs(smpls_dir, exist_ok=True)

    H, W = read_png(os.path.join(images_dir, "000001.png")).shape[:2]
    camera = {
        "R": np.eye(3),
        "t": np.zeros(3),
        "camera_f": np.array([focal, focal], np.float64),
        "camera_c": np.array([H // 2, W // 2], np.float64),
        "camera_k": np.zeros(5),
        "height": H,
        "width": W,
    }
    write_pickle_file(os.path.join(data_root, people_ID, "cam000",
                                   "camera.pkl"), camera)

    vibe = load_vibe_output(os.path.join(data_root, people_ID,
                                         "vibe_output.pkl"))
    track = vibe[track_id]
    cams = np.asarray(track["orig_cam"], np.float32)
    betas = np.asarray(track["betas"], np.float32)
    poses = np.asarray(track["pose"], np.float32)
    frame_ids = np.asarray(track["frame_ids"], np.int64)

    for frame_id in frame_ids:
        cam = cams[frame_id]
        pose = poses[frame_id]
        transl = np.array([cam[2], cam[3], 2 * focal / (cam[0] * H)],
                          np.float32)
        params = {
            "betas": betas[frame_id],
            "global_orient": pose[:3],
            "body_pose": pose[3:],
            "transl": transl,
            "model_type": "smpl",
            "gender": gender,
        }
        write_pickle_file(os.path.join(smpls_dir,
                                       f"{int(frame_id) + 1:06d}.pkl"), params)
    print(f"converted {len(frame_ids)} frames into {smpls_dir}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", type=str, default="data/iper")
    parser.add_argument("--people_ID", type=str, default="iper_023_1_1")
    parser.add_argument("--gender", type=str, default="neutral")
    args = parser.parse_args(argv)
    convert(args.data_root, args.people_ID, args.gender)


if __name__ == "__main__":
    main()
