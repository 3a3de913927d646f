"""People-Snapshot dataset preparation without OpenCV — counterpart of
``animnerf_tpu/tools/people_snapshot.py`` (reference
tools/people_snapshot.py:16-93).

Converts the raw People-Snapshot release of one subject (``<name>.mp4``,
``masks.hdf5``, ``reconstructed_poses.hdf5``, ``camera.pkl``) into the
layout ``cli.train`` reads: ``cam000/camera.pkl``, ``cam000/images/*.png``
(RGBA, the mask in alpha) and ``smpls/*.pkl`` per frame, with the JAX
tool's keys, shapes and dtypes. Where the JAX tool calls OpenCV:

  * ``cv2.Rodrigues`` -> ``rodrigues`` (OpenCV's formula in double);
  * ``cv2.VideoCapture`` -> a decoder, a callable video path ->
    (width, height, count, an iterator of (H, W, 3) uint8 RGB frames),
    count None where the container does not say:
    ``ffmpeg_frames`` (an ``ffmpeg`` subprocess, rawvideo rgb24) by
    default, ``png_frames`` for a directory of extracted frames;
  * ``cv2.resize(INTER_NEAREST)`` of a mask -> ``resize_nearest``;
  * ``cv2.imwrite`` -> ``utils/image.py::write_png`` (RGB frames, so the
    decoded PNGs are the JAX tool's BGR-written ones).

``h5py`` is imported inside ``prepare`` only.

    python -m animnerf_tpu_torch.tools.people_snapshot \
        --people_dir people_snapshot_public/male-3-casual \
        --out_dir data/people_snapshot/male-3-casual
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys

import numpy as np

from animnerf_tpu_torch.smpl.loader import load_pickle
from animnerf_tpu_torch.utils.image import read_rgb, write_png
from animnerf_tpu_torch.utils.io import write_pickle_file

DBL_EPSILON = sys.float_info.epsilon


def rodrigues(r) -> np.ndarray:
    """Rotation vector (3,) -> (3, 3) float64 rotation matrix, OpenCV's
    ``cvRodrigues2`` step by step in double: theta = sqrt((x*x + y*y) +
    z*z); the identity below DBL_EPSILON; else the axis r * (1 / theta)
    and R = (c I + (1 - c) r r^T) + s [r]x, c and s from libm's cos and
    sin (``math``), every product and sum rounded once."""
    x, y, z = (float(v) for v in np.asarray(r, np.float64).reshape(-1)[:3])
    theta = math.sqrt(x * x + y * y + z * z)
    if theta < DBL_EPSILON:
        return np.eye(3)
    c, s = math.cos(theta), math.sin(theta)
    c1 = 1.0 - c
    itheta = 1.0 / theta
    x, y, z = x * itheta, y * itheta, z * itheta
    rrt = (x * x, x * y, x * z, x * y, y * y, y * z, x * z, y * z, z * z)
    r_x = (0.0, -z, y, z, 0.0, -x, -y, x, 0.0)
    eye = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
    return np.array([(c * eye[k] + c1 * rrt[k]) + s * r_x[k]
                     for k in range(9)], np.float64).reshape(3, 3)


def nearest_index(src: int, dst: int) -> np.ndarray:
    """OpenCV's ``resizeNN`` source index per destination index:
    min(floor(i * (1 / (dst / src))), src - 1), the scale and its inverse
    each rounded in double as OpenCV rounds them."""
    ifx = 1.0 / (float(dst) / float(src))
    idx = np.floor(np.arange(dst, dtype=np.float64) * ifx).astype(np.int64)
    return np.minimum(idx, src - 1)


def resize_nearest(img: np.ndarray, size: tuple) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)``: size is
    (width, height); any dtype, (H, W) or (H, W, C)."""
    W, H = size
    ys = nearest_index(img.shape[0], H)
    xs = nearest_index(img.shape[1], W)
    return img[ys[:, None], xs[None, :]]


def ffmpeg_frames(video_path: str):
    """Decode a video with ``ffmpeg`` -> (width, height, count, frames):
    the size and the container's frame count from ``ffprobe`` (as
    OpenCV's CAP_PROP_FRAME_COUNT reads it; None where ``ffprobe`` says
    ``N/A``, and then ``prepare`` reads to the end of the stream), frames
    an iterator of (H, W, 3) uint8 RGB arrays from an ``ffmpeg`` rawvideo
    rgb24 pipe, which is stopped when the iterator is closed or
    finished."""
    probe = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0",
         "-show_entries", "stream=width,height,nb_frames",
         "-of", "csv=p=0", video_path],
        check=True, capture_output=True, text=True).stdout.strip()
    fields = probe.splitlines()[0].split(",")
    width, height = int(fields[0]), int(fields[1])
    count = int(fields[2]) if fields[2].isdigit() else None

    def frames():
        proc = subprocess.Popen(
            ["ffmpeg", "-loglevel", "error", "-i", video_path,
             "-f", "rawvideo", "-pix_fmt", "rgb24", "-"],
            stdout=subprocess.PIPE)
        size = width * height * 3
        try:
            while True:
                buf = proc.stdout.read(size)
                if len(buf) < size:
                    break
                yield np.frombuffer(buf, np.uint8).reshape(height, width, 3)
        finally:
            proc.stdout.close()
            proc.kill()
            proc.wait()

    return width, height, count, frames()


def png_frames(frames_dir: str):
    """A directory of extracted PNG frames (sorted by name) -> (width,
    height, count, frames), the frames RGB (an alpha channel is dropped,
    gray is repeated)."""
    files = sorted(f for f in os.listdir(frames_dir) if f.endswith(".png"))
    if not files:
        raise FileNotFoundError(f"no PNG frames in {frames_dir!r}")

    first = read_rgb(os.path.join(frames_dir, files[0]))
    height, width = first.shape[:2]
    frames = (read_rgb(os.path.join(frames_dir, f)) for f in files)
    return width, height, len(files), frames


def prepare(people_dir: str, out_dir: str, decoder=None,
            frames_dir: str = None) -> int:
    """Write the prepared subject into ``out_dir``; returns the frame
    count. Frames from ``frames_dir`` (PNGs) when given, else from
    ``decoder(<people_dir>/<name>.mp4)`` (default ``ffmpeg_frames``):
    as many as there are masks, poses and frames, to the end of the
    stream where the decoder gives no count. Raises ``RuntimeError``
    when it writes no frame."""
    import h5py

    os.makedirs(out_dir, exist_ok=True)
    img_dir = os.path.join(out_dir, "cam000", "images")
    smpl_dir = os.path.join(out_dir, "smpls")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(smpl_dir, exist_ok=True)

    name = os.path.basename(os.path.normpath(people_dir))
    cam_raw = load_pickle(os.path.join(people_dir, "camera.pkl"))
    if frames_dir is not None:
        width, height, count, frames = png_frames(frames_dir)
    else:
        width, height, count, frames = (decoder or ffmpeg_frames)(
            os.path.join(people_dir, f"{name}.mp4"))

    camera = {
        "R": rodrigues(cam_raw["camera_rt"]),
        "t": np.asarray(cam_raw["camera_t"], np.float64),
        "camera_f": np.asarray(cam_raw["camera_f"], np.float64),
        "camera_c": np.asarray(cam_raw["camera_c"], np.float64),
        "camera_k": np.asarray(cam_raw["camera_k"], np.float64),
        "height": height,
        "width": width,
    }
    write_pickle_file(os.path.join(out_dir, "cam000", "camera.pkl"), camera)

    # poses: pose (F, 72), trans (F, 3), betas
    with h5py.File(os.path.join(people_dir, "reconstructed_poses.hdf5"),
                   "r") as f:
        poses = np.asarray(f["pose"], np.float32)
        trans = np.asarray(f["trans"], np.float32)
        betas = np.asarray(f["betas"], np.float32)[:10]

    n_done = 0
    with h5py.File(os.path.join(people_dir, "masks.hdf5"), "r") as f:
        masks = f["masks"]
        n_frames = min(len(masks), len(poses))
        if count is not None:
            n_frames = min(n_frames, count)
        frames = iter(frames)
        try:
            for i in range(n_frames):
                frame = next(frames, None)
                if frame is None:
                    break
                mask = (np.asarray(masks[i]) > 0).astype(np.uint8) * 255
                if mask.shape[:2] != frame.shape[:2]:
                    mask = resize_nearest(mask, (frame.shape[1],
                                                 frame.shape[0]))
                write_png(os.path.join(img_dir, f"{i + 1:06d}.png"),
                          np.dstack([frame, mask]))
                params = {
                    "betas": betas[None].astype(np.float32),
                    "global_orient": poses[i, :3][None].astype(np.float32),
                    "body_pose": poses[i, 3:][None].astype(np.float32),
                    "transl": trans[i][None].astype(np.float32),
                }
                write_pickle_file(os.path.join(smpl_dir, f"{i + 1:06d}.pkl"),
                                  params)
                n_done += 1
        finally:
            close = getattr(frames, "close", None)
            if close is not None:
                close()
    if n_done == 0:
        raise RuntimeError(
            f"prepared no frame from {people_dir!r}: the video gave none "
            f"(count {count}), or the release has no masks or poses")
    print(f"prepared {n_done} frames into {out_dir}")
    return n_done


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--people_dir", type=str, required=True,
                        help="raw People-Snapshot subject directory")
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--frames_dir", type=str, default=None,
                        help="PNG frames already extracted from the video "
                             "(default: decode <name>.mp4 with ffmpeg)")
    args = parser.parse_args(argv)
    prepare(args.people_dir, args.out_dir, frames_dir=args.frames_dir)


if __name__ == "__main__":
    main()
