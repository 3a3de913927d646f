"""Visualization helpers: jet depth / alpha maps and the GT | prediction |
depth triptych — counterpart of ``animnerf_tpu/utils/vis.py``, with
OpenCV's JET table and the PNG writer of ``utils/image.py``."""

from __future__ import annotations

import numpy as np

from animnerf_tpu_torch.utils.image import apply_jet, write_png


def colorize_depth(depth: np.ndarray) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) uint8 jet colours, normalised with the
    minimum clipped to max - 2."""
    x = np.nan_to_num(np.asarray(depth, np.float32))
    ma = float(x.max())
    mi = min(float(x.min()), ma - 2.0)
    x = (x - mi) / (ma - mi + 1e-8)
    return apply_jet((255 * np.clip(x, 0, 1)).astype(np.uint8))


def colorize_alpha(alpha: np.ndarray) -> np.ndarray:
    x = (255 * np.clip(np.asarray(alpha, np.float32), 0, 1)).astype(np.uint8)
    return apply_jet(x)


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (255 * np.clip(np.asarray(img, np.float32), 0, 1)).astype(np.uint8)


def triptych(img_gt: np.ndarray, img_pred: np.ndarray,
             depth: np.ndarray) -> np.ndarray:
    """GT | pred | depth side by side, uint8 (H, 3W, 3)."""
    return np.concatenate(
        [to_uint8(img_gt), to_uint8(img_pred), colorize_depth(depth)], axis=1)


def save_image(path: str, img: np.ndarray) -> None:
    """img float [0, 1] or uint8, RGB -> a PNG file."""
    if img.dtype != np.uint8:
        img = to_uint8(img)
    write_png(path, img)


def save_triptych(path: str, img_gt, img_pred, depth) -> None:
    save_image(path, triptych(img_gt, img_pred, depth))
