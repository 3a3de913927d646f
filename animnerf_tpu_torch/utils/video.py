"""Video <-> image-sequence utilities — copy of
``animnerf_tpu/utils/video.py``: ``video_to_images`` and
``images_to_video`` run ``ffmpeg``, ``center_crop`` and ``fuse_grid`` are
numpy (reference utils/video_utils.py:20-127, tools/video_to_images.py).
"""

from __future__ import annotations

import os
import subprocess
from typing import Optional

import numpy as np


def video_to_images(video_path: str, out_dir: str, fps: Optional[int] = None,
                    ext: str = "png", start_index: int = 1) -> int:
    """Extract frames with ffmpeg; returns frame count."""
    os.makedirs(out_dir, exist_ok=True)
    cmd = ["ffmpeg", "-y", "-loglevel", "error", "-i", video_path]
    if fps:
        cmd += ["-vf", f"fps={fps}"]
    cmd += ["-start_number", str(start_index),
            os.path.join(out_dir, f"%06d.{ext}")]
    subprocess.run(cmd, check=True)
    return len([f for f in os.listdir(out_dir) if f.endswith(ext)])


def images_to_video(img_dir: str, out_path: str, fps: int = 30,
                    ext: str = "png", start_index: int = 1) -> None:
    cmd = ["ffmpeg", "-y", "-loglevel", "error", "-framerate", str(fps),
           "-start_number", str(start_index),
           "-i", os.path.join(img_dir, f"%06d.{ext}"),
           "-pix_fmt", "yuv420p", out_path]
    subprocess.run(cmd, check=True)


def center_crop(img: np.ndarray, crop_wh: tuple[int, int],
                offset_xy: tuple[int, int] = (0, 0)) -> np.ndarray:
    """Center crop with offsets (reference tools/video_to_images.py crop)."""
    H, W = img.shape[:2]
    cw, ch = crop_wh
    ox, oy = offset_xy
    x0 = max((W - cw) // 2 + ox, 0)
    y0 = max((H - ch) // 2 + oy, 0)
    return img[y0:y0 + ch, x0:x0 + cw]


def fuse_grid(images: list[np.ndarray], ncols: int = 2) -> np.ndarray:
    """Tile images into a grid (reference video_utils.py fuse)."""
    n = len(images)
    nrows = (n + ncols - 1) // ncols
    h, w = images[0].shape[:2]
    canvas = np.zeros((nrows * h, ncols * w, images[0].shape[2]),
                      dtype=images[0].dtype)
    for i, img in enumerate(images):
        r, c = divmod(i, ncols)
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = img
    return canvas
