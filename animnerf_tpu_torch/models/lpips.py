"""LPIPS (AlexNet) perceptual metric — counterpart of
``animnerf_tpu/models/lpips_jax.py``.

The reference scores its test renders with the ``lpips`` package's
LPIPS-AlexNet (reference models/evaluator.py:5,14,20-27) and feeds it
images in [0, 1] without the ``normalize`` flag; the JAX package keeps
that convention and so does the port. The metric, op for op as
``lpips_jax.lpips_distance`` computes it:

  * the scaling layer ``(x - SHIFT) / SCALE`` on the [0, 1] images;
  * five AlexNet stages ``(out, kernel, stride, pad)``, each followed by
    ReLU, a 3x3 stride-2 VALID max-pool after stages 0 and 1;
  * per stage the channel vectors divided by their norm plus 1e-10, the
    squared difference weighted by the stage's non-negative 1x1 head,
    summed over channels and averaged over space; the stages summed.

The JAX package convolves with ``lax.conv_general_dilated`` (no Pallas
kernel), so the port calls ``F.conv2d`` / ``F.max_pool2d``: cuDNN on the
card. cuDNN would take its float32 convolutions on TF32 by default, about
1e-3 relative off float32, so ``LPIPS.forward`` turns TF32 off for its
own convolutions only (``fp32_convolutions``) and changes no setting any
other path reads.

The weights are the JAX package's ``.npz`` (HWIO convolutions, ``lin{i}_w``
heads); ``convert_torch_lpips`` writes it from the torch files the lpips
ecosystem ships, read without torch's unpickler
(``utils/torch_pickle.py``), so either package reads the other's file:

    python -m animnerf_tpu_torch.models.lpips --alexnet alexnet.pth \
        --lin weights/v0.1/alex.pth --out assets/lpips_alex.npz
"""

from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animnerf_tpu_torch.utils.device import DeviceLike, resolve_device

# AlexNet features: (out_channels, kernel, stride, padding)
ALEX_LAYERS = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
POOL_AFTER = {0, 1}
# torchvision's indices of the five convolutions in alexnet.features
TORCH_INDEX = [0, 3, 6, 8, 10]
# the ImageNet scaling of lpips.LPIPS (its scaling layer's shift / scale)
SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def fp32_convolutions():
    """A context in which cuDNN's float32 convolutions stay float32 (TF32
    off); cuDNN's other settings as they are, all restored on exit."""
    cd = torch.backends.cudnn
    if not cd.is_available():
        return contextlib.nullcontext()
    return cd.flags(enabled=cd.enabled, benchmark=cd.benchmark,
                    deterministic=cd.deterministic, allow_tf32=False)


class LPIPS(nn.Module):
    """LPIPS-AlexNet: ``forward(img0, img1)`` takes two (N, 3, H, W)
    float32 batches in [0, 1] and returns the (N,) distances. ``params``
    is the ``.npz`` layout (HWIO convolutions), as ``random_params`` and
    ``load_params`` give it."""

    def __init__(self, params: dict):
        super().__init__()
        for i, (_, _, stride, pad) in enumerate(ALEX_LAYERS):
            w = np.asarray(params[f"conv{i}_w"], np.float32)
            conv = nn.Conv2d(w.shape[2], w.shape[3], w.shape[0],
                             stride=stride, padding=pad)
            with torch.no_grad():
                conv.weight.copy_(torch.from_numpy(
                    np.ascontiguousarray(w.transpose(3, 2, 0, 1))))
                conv.bias.copy_(torch.from_numpy(
                    np.asarray(params[f"conv{i}_b"], np.float32)))
            setattr(self, f"conv{i}", conv)
            self.register_buffer(f"lin{i}", torch.from_numpy(
                np.asarray(params[f"lin{i}_w"], np.float32).reshape(-1)))
        self.register_buffer("shift", torch.from_numpy(SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(SCALE).view(1, 3, 1, 1))
        self.requires_grad_(False)

    def features(self, x: torch.Tensor) -> list:
        """(N, 3, H, W) images already shifted and scaled -> the five
        stages' activations after their ReLU."""
        feats = []
        h = x
        for i, (_, _, stride, pad) in enumerate(ALEX_LAYERS):
            conv = getattr(self, f"conv{i}")
            h = torch.relu(F.conv2d(h, conv.weight, conv.bias, stride=stride,
                                    padding=pad))
            feats.append(h)
            if i in POOL_AFTER:
                h = F.max_pool2d(h, 3, stride=2)
        return feats

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        with fp32_convolutions():
            f0 = self.features((img0 - self.shift) / self.scale)
            f1 = self.features((img1 - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(f0, f1)):
            a = a / (a.norm(dim=1, keepdim=True) + 1e-10)
            b = b / (b.norm(dim=1, keepdim=True) + 1e-10)
            diff = (a - b) ** 2
            lin = getattr(self, f"lin{i}").view(1, -1, 1, 1)
            total = total + (diff * lin).sum(dim=1).mean(dim=(1, 2))
        return total


def load_params(path: str) -> dict:
    """The ``.npz`` weights file as a dict of numpy arrays (HWIO)."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def load_weights(path: str, device: DeviceLike = None) -> LPIPS:
    """``LPIPS`` with the ``.npz``'s weights (convolutions transposed to
    OIHW), on the card unless ``device="cpu"``. An unreadable file or a
    missing key raises."""
    return LPIPS(load_params(path)).to(resolve_device(device)).eval()


def random_params(seed: int = 0) -> dict:
    """Random weights of the right shapes (tests, the chip script): the
    JAX package's ``random_params`` draws, in its order, as numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    cin = 3
    for i, (cout, kk, _, _) in enumerate(ALEX_LAYERS):
        out[f"conv{i}_w"] = rng.normal(
            scale=0.05, size=(kk, kk, cin, cout)).astype(np.float32)
        out[f"conv{i}_b"] = np.zeros(cout, np.float32)
        out[f"lin{i}_w"] = rng.uniform(0, 0.1, size=cout).astype(np.float32)
        cin = cout
    return out


def convert_torch_lpips(alexnet_ckpt: str, lpips_lin_ckpt: str,
                        out_path: str) -> str:
    """Convert torch AlexNet features and lpips heads to the ``.npz``.

    Accepts every layout the lpips ecosystem ships:
      * alexnet_ckpt: torchvision's alexnet state dict
        (``features.{0,3,6,8,10}.{weight,bias}``) or a full
        ``lpips.LPIPS`` state dict (``net.slice{1..5}.{0,3,6,8,10}.*``);
      * lpips_lin_ckpt: the package's ``weights/v0.1/alex.pth``
        (``lin{0..4}.model.1.weight``) or the full-module dict
        (``lins.{0..4}.model.1.weight``); one file may be both arguments.
    Writes the JAX package's keys, dtypes and layout; returns out_path."""
    from animnerf_tpu_torch.utils.torch_pickle import load_torch_checkpoint

    alex = load_torch_checkpoint(alexnet_ckpt)
    alex = alex.get("state_dict", alex)
    lin = (alex if lpips_lin_ckpt == alexnet_ckpt
           else load_torch_checkpoint(lpips_lin_ckpt))
    lin = lin.get("state_dict", lin)

    out = {}
    for i, ti in enumerate(TORCH_INDEX):
        for key in (f"features.{ti}", f"net.slice{i + 1}.{ti}"):
            if f"{key}.weight" in alex:
                break
        else:
            raise KeyError(
                f"conv{i} weights (features.{ti} / net.slice{i + 1}.{ti}) "
                f"not found in {alexnet_ckpt}")
        w = np.asarray(alex[f"{key}.weight"])          # (O, I, kh, kw)
        out[f"conv{i}_w"] = w.transpose(2, 3, 1, 0)    # HWIO
        out[f"conv{i}_b"] = np.asarray(alex[f"{key}.bias"])
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in lin:
                out[f"lin{i}_w"] = np.asarray(lin[key]).reshape(-1)
                break
        else:
            raise KeyError(f"lin{i} weights not found in {lpips_lin_ckpt}")
    np.savez(out_path, **out)
    return out_path


def to_batch(img: np.ndarray, device) -> torch.Tensor:
    """(H, W, 3) numpy -> a (1, 3, H, W) float32 tensor on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    return t.permute(2, 0, 1)[None].to(device)


class LPIPSMetric:
    """The evaluator's LPIPS: ``(pred, target)`` as (H, W, 3) numpy
    images in [0, 1] -> a float, computed on the model's device."""

    def __init__(self, weights_path: str, device: DeviceLike = None):
        self.model = load_weights(weights_path, device)
        self.device = self.model.lin0.device

    def __call__(self, pred: np.ndarray, target: np.ndarray) -> float:
        with torch.no_grad():
            d = self.model(to_batch(pred, self.device),
                           to_batch(target, self.device))
        return float(d[0])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="convert torch LPIPS-AlexNet weights to the .npz")
    p.add_argument("--alexnet", required=True,
                   help="torchvision alexnet .pth or a full lpips.LPIPS "
                        "state dict")
    p.add_argument("--lin", default=None,
                   help="the lpips heads (weights/v0.1/alex.pth); default: "
                        "the --alexnet file")
    p.add_argument("--out", default="assets/lpips_alex.npz")
    args = p.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = convert_torch_lpips(args.alexnet, args.lin or args.alexnet,
                              args.out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
