"""Image-quality metrics: PSNR, SSIM and LPIPS — counterpart of
``animnerf_tpu/models/evaluator.py`` (reference models/evaluator.py:9-27).

PSNR with data_range 1.0 and SSIM with the 11 x 11 gaussian window
(Wang et al. 2004, torchmetrics' definition), both in float64 numpy /
scipy as the JAX package computes them, so one image pair scores the same
in both packages. LPIPS-AlexNet is ``models/lpips.py`` on the card (on
[0, 1] images without the [-1, 1] mapping, the reference's convention),
from the ``.npz`` weights file the JAX package reads: ``lpips_weights``,
else ``$ANIMNERF_LPIPS_WEIGHTS``, else ``assets/lpips_alex.npz``. Without
that file ``Evaluator`` reports ``psnr`` and ``ssim`` only. The JAX
package then tries the ``lpips`` pip package, which downloads its
weights; the port has no counterpart of that fallback, and makes the
file from weights the user has with ``python -m
animnerf_tpu_torch.models.lpips``.
"""

from __future__ import annotations

import os

import numpy as np

from animnerf_tpu_torch.models.lpips import LPIPSMetric
from animnerf_tpu_torch.utils.device import DeviceLike

DEFAULT_LPIPS_WEIGHTS = "assets/lpips_alex.npz"

def psnr(pred: np.ndarray, target: np.ndarray,
         data_range: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(pred, np.float64)
                         - np.asarray(target, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range**2 / mse)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def ssim(pred: np.ndarray, target: np.ndarray, data_range: float = 1.0,
         k1: float = 0.01, k2: float = 0.03) -> float:
    """Mean SSIM with the standard 11x11 gaussian window (Wang et al. 2004,
    the same definition torchmetrics uses). Inputs (H, W, C) in [0, 1]."""
    from scipy.signal import convolve2d

    p = np.asarray(pred, np.float64)
    t = np.asarray(target, np.float64)
    if p.ndim == 2:
        p, t = p[..., None], t[..., None]
    kern = _gaussian_kernel()
    window = np.outer(kern, kern)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    vals = []
    for c in range(p.shape[-1]):
        x, y = p[..., c], t[..., c]
        mu_x = convolve2d(x, window, mode="valid")
        mu_y = convolve2d(y, window, mode="valid")
        xx = convolve2d(x * x, window, mode="valid") - mu_x**2
        yy = convolve2d(y * y, window, mode="valid") - mu_y**2
        xy = convolve2d(x * y, window, mode="valid") - mu_x * mu_y
        s = ((2 * mu_x * mu_y + c1) * (2 * xy + c2)) / (
            (mu_x**2 + mu_y**2 + c1) * (xx + yy + c2))
        vals.append(s.mean())
    return float(np.mean(vals))


class Evaluator:
    """The per-image metrics of the evaluation: {"psnr", "ssim"} and
    "lpips" where the weights file exists (on ``device``: the card unless
    "cpu" is asked for). A file that exists but cannot be read raises."""

    def __init__(self, use_lpips: bool = True,
                 lpips_weights: "str | None" = None,
                 device: DeviceLike = None):
        self.lpips = None
        if use_lpips:
            weights = lpips_weights or os.environ.get(
                "ANIMNERF_LPIPS_WEIGHTS", DEFAULT_LPIPS_WEIGHTS)
            if os.path.exists(weights):
                self.lpips = LPIPSMetric(weights, device)

    def __call__(self, img_pred: np.ndarray, img_gt: np.ndarray) -> dict:
        out = {"psnr": psnr(img_pred, img_gt), "ssim": ssim(img_pred, img_gt)}
        if self.lpips is not None:
            out["lpips"] = self.lpips(img_pred, img_gt)
        return out
